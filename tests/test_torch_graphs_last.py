"""The reference's last eager jit sites, captured (asdslam_torch/utils/graphs.py):
the mesh BA step's two halves, the data-parallel descriptor's shard program,
the ASDNet train step (forward, backward and update in one graph), the three
renderers, the greedy engine and the 3D-3D Sim3 alignment.

Each is a module-level ``graphs.captured`` callable that its callers reach;
on the CPU it is its eager function (``last_call() == "eager"``).  The
graph path runs here through fakes of the card's side (a fake graph runs the
function on its static buffers at each replay, as tests/test_torch_graphs.py
does), which walks the keys, the static buffers and the clones: warm-up,
capture and replays equal the eager function bit for bit.  Against the JAX
package, on the CPU:

- the train step with a tensor lr, the SGD update in place and the running
  statistics in place, on replayed JAX draws: one step within
  tests/test_torch_train.py's bars (loss 1e-5, running means 1e-5, running
  variances 1e-5 relative, convs 1e-3), five chained steps within its
  looser ones (loss 0.05, convs 0.1);
- the split mesh step at 1, 2, 4 and 8 shards: bitwise equal across shard
  counts, and within tests/test_torch_parallel.py's float64 bars of the JAX
  ``distributed_ba_step``'s step (poses 1e-6, points 5e-6);
- ``render_frame`` with a numpy K, a tensor K and a lens, ``render_boxes``
  and ``raycast_grid`` with and without depth: at most 0.1% of a frame's
  pixels moved by more than 1e-5 (tests/test_torch_proxy.py's bar);
- the greedy engine: equal; the Sim3 alignment: the same inliers, s / R / t
  within 1e-5 (tests/test_torch_loop.py's bar).

The card's checks (chip_smoke.py phase 16a) are the ``gpu`` test of
tests/test_torch_graphs_last_card.py, a file without JAX.
"""

import os
import sys
import types
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from asdslam_tpu.io import kitti_proxy as jkp  # noqa: E402
from asdslam_tpu.io import synthetic as jsyn  # noqa: E402
from asdslam_tpu.models import asdnet as jnet  # noqa: E402
from asdslam_tpu.models import train as jtr  # noqa: E402
from asdslam_tpu.ops import assignment as jassign  # noqa: E402
from asdslam_tpu.parallel import dist as jdist  # noqa: E402
from asdslam_torch.config import SlamConfig  # noqa: E402
from asdslam_torch.io import euroc_proxy as teu  # noqa: E402
from asdslam_torch.io import kitti_proxy as tkp  # noqa: E402
from asdslam_torch.io import synthetic as tsyn  # noqa: E402
from asdslam_torch.loop.loop_closing import LoopCloser  # noqa: E402
from asdslam_torch.models import asdnet as tnet  # noqa: E402
from asdslam_torch.models import proxy_pairs  # noqa: E402
from asdslam_torch.models import train as ttr  # noqa: E402
from asdslam_torch.ops import assignment as tassign  # noqa: E402
from asdslam_torch.parallel import dist as tdist  # noqa: E402
from asdslam_torch.utils import graphs  # noqa: E402

SITES = chip_smoke.LAST_SITES
KM = chip_smoke.MD_K
EUROC_DIST = tuple(float(x) for x in chip_smoke.EUROC_CAM.split(",")[4:])
MOVED, PIXEL_SHARE_BAR = 1e-5, 1e-3   # tests/test_torch_proxy.py's bar


def site(name):
    return chip_smoke.jit_site(name)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs beside other workers on few cores
    (tests/test_torch_train.py does the same)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_graphs_kept():
    """No fake graph of a module-level site outlives a test."""
    for name in SITES:
        site(name)._entries.clear()
    yield
    for name in SITES:
        site(name)._entries.clear()


def swap(x, f):
    """``x`` (tuples, named tuples, lists, dicts) with ``f`` applied to its
    leaves."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(swap(v, f) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(swap(v, f) for v in x)
    if isinstance(x, dict):
        return {k: swap(v, f) for k, v in x.items()}
    return f(x)


class FakeGraph:
    """Replays by running the function on the static inputs and writing the
    results into the static outputs.  It holds the modules among the
    arguments weakly, as a real graph holds no Python object."""

    def __init__(self, fn, args, kwargs, out):
        self.fn, self.out = fn, out
        self.inputs = swap((args, kwargs), lambda v: weakref.ref(v)
                           if isinstance(v, torch.nn.Module) else v)

    def replay(self):
        args, kwargs = swap(self.inputs, lambda v: v() if isinstance(v, weakref.ref) else v)
        dst, src = [], []
        graphs._flatten(self.out, dst)
        graphs._flatten(self.fn(*args, **kwargs), src)
        for d, s in zip(dst, src):
            d.copy_(s)


def constants(x):
    """The non-tensor leaves of a tree of arguments."""
    if isinstance(x, (tuple, list)):
        return [c for v in x for c in constants(v)]
    if isinstance(x, dict):
        return [c for v in x.values() for c in constants(v)]
    return [] if isinstance(x, torch.Tensor) else [x]


@pytest.fixture
def card(monkeypatch):
    """The CPU as the card: every call with tensors takes the graph path.
    Yields a dict counting the warm-ups and captures."""
    state = {"warm": 0, "capture": 0}

    def warm(fn, args, kwargs, device):
        state["warm"] += 1
        return fn(*args, **kwargs)

    def capture(fn, args, kwargs, device):
        # a capture executes nothing: the modules the function updates in
        # place (constant leaves, such as the train step's model) get
        # their state back after the fake's run
        state["capture"] += 1
        modules = [m for m in constants((args, kwargs)) if isinstance(m, torch.nn.Module)]
        saved = [[t.clone() for t in m.state_dict().values()] for m in modules]
        out = fn(*args, **kwargs)
        with torch.no_grad():
            for m, ts in zip(modules, saved):
                for t, s in zip(m.state_dict().values(), ts):
                    t.copy_(s)
        return FakeGraph(fn, args, kwargs, out), out

    monkeypatch.setattr(graphs, "_graph_device",
                        lambda leaves: leaves[0].device if leaves else None)
    monkeypatch.setattr(graphs, "_capturing", lambda: False)
    monkeypatch.setattr(graphs, "_stream_key", lambda device: 1)
    monkeypatch.setattr(graphs, "_warm", warm)
    monkeypatch.setattr(graphs, "_capture", capture)
    yield state


@pytest.fixture
def reached(monkeypatch):
    """``reached(name)`` wraps the named site's module attribute with a
    counter and returns the list of what each call did."""
    def wrap(name):
        (module, attr), = chip_smoke.site_owners([name])
        real, kinds = getattr(module, attr), []

        def counted(*a, **kw):
            out = real(*a, **kw)
            kinds.append(graphs.last_call())
            return out
        monkeypatch.setattr(module, attr, counted)
        return kinds
    return wrap


def same(a, b):
    return chip_smoke.tree_same_bits(a, b)


def moved_share(a, b):
    return float(np.mean(np.abs(np.asarray(a) - np.asarray(b)) > MOVED))


# --------------------------------------------------------------------------- #
# The sites
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(SITES))
def test_site_is_a_module_level_capture(name):
    """Each new site is a graphs.captured callable at module level, named
    after the reference's jit, whose file:line holds that jit."""
    module_name, attr, ref = SITES[name]
    (module, _), = chip_smoke.site_owners([name])
    captured = getattr(module, attr)
    assert isinstance(captured, graphs.Captured) and module.__name__ == module_name
    assert captured.grad == (name == "train_step")
    path, line = ref.rsplit(":", 1)
    with open(os.path.join(ROOT, path)) as f:
        assert "jax.jit" in f.read().splitlines()[int(line) - 1]
    assert not captured.eager.__name__.startswith("<")  # a named function, not a lambda


def test_train_step_caller_reaches_the_capture(reached):
    kinds = reached("train_step")
    ttr.train_asdnet(0, n_steps=2, batch_size=16, device="cpu")
    assert kinds == ["eager", "eager"] and graphs.last_call() == "eager"


def test_mesh_gba_caller_reaches_the_captures(reached):
    """LoopCloser._global_ba_mesh (with a closer's state on a small problem)
    runs loop_gba_iters steps, each through both halves."""
    kinds = {name: reached(name) for name in chip_smoke.MESH_HALVES}
    poses0, pts0, cam_idx, pt_idx, uv, inv_s2, valid = chip_smoke.make_problem_np()
    cfg = SlamConfig(n_devices=4, loop_gba_iters=3)
    closer = types.SimpleNamespace(cfg=cfg, store=types.SimpleNamespace(mp_pos=pts0),
                                   K=torch.tensor(KM), device="cpu",
                                   _dev=lambda x: torch.as_tensor(x))
    poses, points = LoopCloser._global_ba_mesh(closer, poses0, np.arange(len(pts0)), cam_idx,
                                               pt_idx, uv, inv_s2, valid, n_opt=3)
    assert all(k == ["eager"] * 3 for k in kinds.values()), kinds
    assert graphs.last_call() == "eager" and np.isfinite(points).all()
    assert not np.array_equal(poses[:3], poses0[:3]) and np.array_equal(poses[3], poses0[3])


def test_dp_descriptor_caller_reaches_the_capture(reached):
    kinds = reached("dp_descriptor")
    params = tnet.params_from_jax(jnet.init_params(jax.random.PRNGKey(0)))
    fn = tdist.dp_descriptor_fn(params, tdist.make_mesh(4, "cpu"))
    out = fn(torch.rand(16, 32, 32, generator=torch.Generator().manual_seed(0)))
    assert out.shape == (16, 128) and kinds == ["eager"] * 4


def test_renderer_callers_reach_the_captures(reached, tmp_path, monkeypatch):
    """EurocProxySequence[i] (raycast_grid), KittiProxySequence[i] and
    ProxyPairSource (render_boxes, with depth), render_sequence
    (render_frame)."""
    kinds = {name: reached(name) for name in ("render_frame", "render_boxes", "raycast_grid")}
    seq = teu.EurocProxySequence(n_frames=4, scale=0.1, n_boxes=8, device="cpu")
    seq[1]
    assert kinds["raycast_grid"] == ["eager"]
    monkeypatch.setattr(tkp, "GT_DIR", str(tmp_path))
    monkeypatch.setattr(tkp, "CAM_DIR", str(tmp_path))
    chip_smoke.write_kitti_ground_truth(str(tmp_path), n=12)
    kseq = tkp.KittiProxySequence("03", scale=0.1, n_boxes=16, device="cpu")
    kseq[2]
    assert kinds["render_boxes"] == ["eager"]
    pairs = proxy_pairs.ProxyPairSource("03", scale=0.1, n_boxes=16, device="cpu")
    img, depth = pairs._render(3)
    assert img.shape == depth.shape == (kseq.height, kseq.width)
    assert kinds["render_boxes"] == ["eager"] * 2
    K = torch.tensor([[26.0, 0, 16.0], [0, 26.0, 12.0], [0, 0, 1.0]])
    tsyn.render_sequence(K, 2, 24, 32, device="cpu")
    assert kinds["render_frame"] == ["eager"] * 2 and graphs.last_call() == "eager"


def test_engine_caller_reaches_the_capture(reached):
    kinds = reached("greedy_assignment")
    col, ok = tassign.greedy_assignment(torch.rand(6, 5), torch.ones(6, 5, dtype=torch.bool))
    assert kinds == ["eager"] and int(ok.sum()) == 5


# --------------------------------------------------------------------------- #
# The train step
# --------------------------------------------------------------------------- #
def T(x):
    return torch.from_numpy(np.asarray(x))


def jax_step_draws(key, batch):
    """The draws the JAX train_step makes from ``key`` (tests/test_torch_train.py)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_train import jax_step_draws as draws

    return draws(key, batch)


def train_steps(n_steps, step_fn, batch=32, base_lr=0.5):
    """n_steps of the JAX trainer and ``step_fn`` (the port's) from the
    JAX init parameters on the same batches, the JAX draws replayed.
    Yields (JAX loss, port loss, JAX params, port model) after each."""
    params = jnet.init_params(jax.random.PRNGKey(0))
    model = tnet.ASDNetTrain(params)
    key = jax.random.PRNGKey(1)
    lrs = ttr.lr_table(2 * n_steps, base_lr, "cpu")
    for step in range(n_steps):
        key, kb, ks = jax.random.split(key, 3)
        a, p = jtr.make_batch(kb, batch)
        adaptive = step < max(1, n_steps // 2)
        params, _, jloss = jtr.train_step(params, None, a, p, ks,
                                          ttr.lr_schedule(step, 2 * n_steps, base_lr),
                                          adaptive=adaptive)
        tloss = step_fn(model, T(a), T(p), lrs[step], jax_step_draws(ks, batch),
                        adaptive=adaptive)
        yield float(jloss), float(tloss), jax.device_get(params), model


def diffs(jparams, model):
    ours = model.params_to_jax()
    conv = max(float(np.abs(x - y).max()) for x, y in zip(ours["conv"], jparams["conv"]))
    mean = max(float(np.abs(x - y).max()) for x, y in zip(ours["bn_mean"], jparams["bn_mean"]))
    var = max(float((np.abs(x - y) / y).max()) for x, y in zip(ours["bn_var"], jparams["bn_var"]))
    return conv, mean, var


@pytest.mark.parametrize("path", ["eager", "graph"])
def test_train_step_against_reference(path, request):
    """One step (tensor lr, SGD and running statistics in place) against the
    JAX train_step on its replayed draws, eagerly and through the graph
    path."""
    if path == "graph":
        request.getfixturevalue("card")
    (jloss, tloss, jparams, model), = train_steps(1, ttr.train_step)
    conv, mean, var = diffs(jparams, model)
    assert abs(jloss - tloss) < 1e-5 and conv < 1e-3 and mean < 1e-5 and var < 1e-5, \
        (jloss, tloss, conv, mean, var)


def test_five_chained_captured_steps_against_reference(card):
    """Five chained steps through the graph path (a warm-up, a capture,
    replays; adaptive switches after two, a second key) within the looser
    bars."""
    for jloss, tloss, jparams, model in train_steps(5, ttr.train_step):
        conv, _, _ = diffs(jparams, model)
        assert abs(jloss - tloss) < 0.05 and conv < 0.1, (jloss, tloss, conv)
    assert (card["warm"], card["capture"]) == (2, 2)
    assert len(ttr.train_step._entries) == 2


def test_captured_train_steps_equal_eager_in_place(card):
    """Five steps through the graph path equal five eager steps bit for bit
    (losses, convs, running statistics); the module's parameters and
    buffers are updated where they lie, and no .grad is left."""
    runs = []
    for step_fn in (ttr.train_step.eager, ttr.train_step):
        model = tnet.ASDNetTrain(tnet.init_params(
            tnet.draw_init_seeds(torch.Generator().manual_seed(0))))
        ptrs = [t.data_ptr() for t in model.state_dict().values()]
        g = torch.Generator().manual_seed(1)
        a, p = ttr.make_batch(ttr.draw_batch(g, 16))
        lrs = ttr.lr_table(5, 0.5, "cpu")
        losses = [step_fn(model, a, p, lrs[i], ttr.draw_step(g, 16)) for i in range(5)]
        assert [t.data_ptr() for t in model.state_dict().values()] == ptrs
        assert all(c.grad is None for c in model.conv)
        runs.append((losses, list(model.state_dict().values())))
    assert same(tuple(runs[0][0]), tuple(runs[1][0]))
    assert same(tuple(runs[0][1]), tuple(runs[1][1]))
    assert graphs.last_call() == "replay" and card["capture"] == 1


def test_a_collected_model_takes_its_graphs_along(card):
    """The model is a constant leaf of the train step's key by its id: its
    graphs go at the first call after it is collected, and no key keeps
    it alive."""
    import gc

    g = torch.Generator().manual_seed(1)
    a, p = ttr.make_batch(ttr.draw_batch(g, 8))
    lr = torch.tensor(0.1)
    models = []
    for seed in (0, 1):
        model = tnet.ASDNetTrain(tnet.init_params(
            tnet.draw_init_seeds(torch.Generator().manual_seed(seed))))
        for _ in range(2):
            ttr.train_step(model, a, p, lr, ttr.draw_step(g, 8))
        models.append(weakref.ref(model))
        del model
        gc.collect()
        assert models[-1]() is None
    assert len(ttr.train_step.stats()) == 0 and not ttr.train_step._entries
    assert card["capture"] == 2


def test_lr_table_is_the_schedule():
    lrs = ttr.lr_table(300, 0.5, "cpu")
    assert lrs.dtype == torch.float32 and lrs.shape == (300,)
    assert [float(x) for x in lrs] == [ttr.lr_schedule(i, 300, 0.5) for i in range(300)]


# --------------------------------------------------------------------------- #
# The mesh step
# --------------------------------------------------------------------------- #
def mesh_run(n, problem, steps=1):
    return chip_smoke.md_steps(tdist.make_mesh(n, "cpu"), problem, steps=steps)


def jax_step_x64(problem, n_dev, n_opt):
    """One JAX point-major step in float64 on its ``n_dev``-device mesh
    (tests/test_torch_parallel.py)."""
    layout = jdist.layout_point_major(*problem[1:], n_dev)
    with jax.enable_x64(True):
        f = jdist.make_pm_step(jdist.make_mesh(n_dev), n_opt, 1e-4)
        f64 = [jnp.asarray(x, jnp.float64) for x in (problem[0], layout[0], layout[3],
                                                     layout[4], KM)]
        jp, jx = f(f64[0], f64[1], jnp.asarray(layout[1]), jnp.asarray(layout[2]), f64[2],
                   f64[3], jnp.asarray(layout[5]), f64[4])
        return np.asarray(jp), np.asarray(jx)[:len(problem[1])]


@pytest.mark.parametrize("n", chip_smoke.MD_SHARDS)
def test_split_mesh_step_against_reference(n, card):
    """The split step through the graph path on n shards: within the float64
    bars of the JAX step on as many devices, bitwise the eager step, and
    one key a half for three steps."""
    problem = chip_smoke.make_problem_np()
    jp, jx = jax_step_x64(problem, n, 3)
    tp, tx = mesh_run(n, problem)
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    np.testing.assert_allclose(tx, jx, atol=5e-6)
    three = mesh_run(n, problem, steps=3)
    with chip_smoke.eager_sites(list(chip_smoke.MESH_HALVES)):
        eager = mesh_run(n, problem, steps=3)
    assert all(np.array_equal(a, b) for a, b in zip(three, eager))
    for name in chip_smoke.MESH_HALVES:
        assert len(site(name)._entries) == 1 and site(name).stats()[0]["replays"] >= 2


def test_split_mesh_step_bitwise_across_shard_counts(card):
    problem = chip_smoke.make_problem_np(n_pts=96)
    runs = {n: mesh_run(n, problem, steps=2) for n in chip_smoke.MD_SHARDS}
    for n in chip_smoke.MD_SHARDS[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(runs[n], runs[1])), n


def test_dp_descriptor_through_the_graph_path(card):
    params = tnet.params_from_jax(jnet.init_params(jax.random.PRNGKey(0)))
    patches = torch.rand(32, 32, 32, generator=torch.Generator().manual_seed(0))
    net = tnet.ASDNet()
    net.load_state_dict(params)
    fn = tdist.dp_descriptor_fn(params, tdist.make_mesh(4, "cpu"))
    with chip_smoke.eager_sites(["dp_descriptor"]):
        want = fn(patches)
    with torch.no_grad():
        np.testing.assert_allclose(want.numpy(), net(patches).numpy(), atol=2e-2)
    for _ in range(3):
        assert torch.equal(fn(patches), want)
    assert len(site("dp_descriptor")._entries) == 1 and card["capture"] == 1


# --------------------------------------------------------------------------- #
# The renderers and the engine
# --------------------------------------------------------------------------- #
K_SMALL = np.float32([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])


@pytest.mark.parametrize("form", ["numpy K", "tensor K, EuRoC lens", "numpy K, lens"])
def test_render_frame_against_reference(form, card):
    """render_frame through the graph path on three frames (warm-up,
    capture, replay) against the JAX render_frame."""
    dist = None if form == "numpy K" else (EUROC_DIST if "EuRoC" in form
                                           else (-0.28, 0.07, 0.0, 0.0))
    K = torch.tensor(K_SMALL) if form.startswith("tensor") else K_SMALL
    poses = np.asarray(jsyn.make_trajectory(3, 0.25, 0.004))
    for i in range(3):
        ref = np.asarray(jsyn.render_frame(jnp.asarray(poses[i]), jnp.asarray(K_SMALL), 240,
                                           320, dist=dist))
        out = tsyn.render_frame(torch.tensor(poses[i]), K, 240, 320, dist=dist)
        assert out.shape == (240, 320) and moved_share(out, ref) <= PIXEL_SHARE_BAR
        eager = tsyn._frame(torch.tensor(poses[i]), torch.tensor(K_SMALL), 240, 320,
                            tsyn.Scene(), None if dist is None else
                            tsyn.camera_mod.Camera.create(1.0, 1.0, 0.0, 0.0, *dist,
                                                          device="cpu"))
        assert torch.equal(out, eager)
    assert card["capture"] == 1


@pytest.mark.parametrize("depth", [False, True])
def test_box_renderers_against_reference(depth, card, tmp_path):
    """render_boxes and raycast_grid through the graph path on three frames
    of tests/test_torch_proxy.py's street world at 124x38 against the JAX
    renderers."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_proxy import write_tum

    path = str(tmp_path / "gt.txt")
    write_tum(path)
    _, pose7, centers = tkp.load_tum_trajectory(path)
    world = tkp.build_world(centers)
    K = np.array([[71.8, 0, 60.7], [0, 71.8, 18.5], [0, 0, 1]], np.float32)
    v, u = np.meshgrid(np.arange(38, dtype=np.float32), np.arange(124, dtype=np.float32),
                       indexing="ij")
    xn, yn = (u - 60.7) / 71.8, (v - 18.5) / 71.8
    for i in (0, 50, 110):   # tests/test_torch_proxy.py's street and frames
        w = tkp.select_boxes(world, centers[i], 64)
        jargs = [jnp.asarray(x) for x in (w.bmin, w.bmax, w.salt)]
        refs = (jkp.render_boxes(jnp.asarray(pose7[i]), jnp.asarray(K), *jargs, 38, 124,
                                 return_depth=depth),
                jkp.raycast_grid(jnp.asarray(pose7[i]), jnp.asarray(xn), jnp.asarray(yn),
                                 *jargs, return_depth=depth))
        outs = (tkp.render_boxes(torch.from_numpy(pose7[i]), torch.from_numpy(K), w.bmin,
                                 w.bmax, w.salt, 38, 124, return_depth=depth),
                tkp.raycast_grid(pose7[i], torch.from_numpy(xn), torch.from_numpy(yn), w.bmin,
                                 w.bmax, w.salt, return_depth=depth))
        for ref, out in zip(refs, outs):
            img, ref_img = (out[0], ref[0]) if depth else (out, ref)
            assert moved_share(img, ref_img) <= PIXEL_SHARE_BAR
            if depth:
                np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-5)
        # the graph path's frames are the eager functions' bit for bit
        assert same(outs[0], tkp._boxes_frame(tkp._on(pose7[i], "cpu"), torch.from_numpy(K),
                                              *tkp._boxes_on(w.bmin, w.bmax, w.salt, "cpu"),
                                              38, 124, 0.35, depth))
    assert card["capture"] == 2 and len(site("render_boxes")._entries) == 1


def test_greedy_engine_against_reference(card):
    g = np.random.default_rng(3)
    for _ in range(3):
        score = (g.integers(0, 20, (40, 30)) / 20).astype(np.float32)
        valid = g.uniform(size=(40, 30)) < 0.4
        jcol, jok = jassign.greedy_assignment(jnp.asarray(score), jnp.asarray(valid),
                                              min_score=0.1)
        tcol, tok = tassign.greedy_assignment(torch.tensor(score), torch.tensor(valid), 0.1)
        assert np.array_equal(tcol.numpy(), np.asarray(jcol))
        assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert card["capture"] == 1


def test_sim3_align_against_reference(card):
    """optimize_sim3_align (no caller on the system's paths) through the
    graph path on tests/test_torch_loop.py's problem: the JAX package's
    inliers, s / R / t within 1e-5, and bitwise the eager function."""
    from asdslam_tpu.estimators import sim3_horn as jsh
    from asdslam_torch.estimators import sim3_horn as tsh

    X, Y = chip_smoke.sim3_align_problem()
    j = jsh.optimize_sim3_align(jnp.asarray(X), jnp.asarray(Y), jnp.ones(len(X), bool))
    args = (torch.tensor(X), torch.tensor(Y), torch.ones(len(X), dtype=torch.bool))
    want = tsh.optimize_sim3_align.eager(*args)
    for _ in range(3):
        got = tsh.optimize_sim3_align(*args)
        assert same(got, want)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(j[3]))
    for a, b in zip(j[:3], got[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)
    assert card["capture"] == 1


# --------------------------------------------------------------------------- #
# chip_smoke.py phase 16's checks, rehearsed through the graph path
# --------------------------------------------------------------------------- #
@pytest.fixture
def host_clock(monkeypatch, card):
    """Phase 16's helpers on the CPU: no synchronisation, host-clock
    timings."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps: chip_smoke.timed_call(fn)[1])
    return card


def test_phase16_mesh_checks_rehearsed(host_clock, monkeypatch):
    monkeypatch.setattr(chip_smoke, "MD_SHARDS", (1, 4))
    halves = chip_smoke.mesh_step_checks("cpu", "CPU")
    assert set(halves) == {f"{h} {n} shards" for h in chip_smoke.MESH_HALVES for n in (1, 4)}
    for c in halves.values():
        assert [k for k, _ in c["calls"]] == ["warm-up", "capture", "replay"]


def test_phase16_train_checks_rehearsed(host_clock, monkeypatch, tmp_path):
    for name, value in (("TRAIN_BATCH", 16), ("N_TRAIN_CHECK", 3), ("N_TRAIN_RATE", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    cache = str(tmp_path / "pairs.npz")
    ttr.write_pair_cache(cache, 64, 16)
    out = chip_smoke.train_checks(cache, "cpu", "CPU")
    assert out["deterministic"]["loss_diff"] == out["deterministic"]["conv_diff"] == 0.0
    assert set(out["steps_per_s"]) == {"captured", "eager", "eager again", "captured again"}


def test_phase16_engine_check_rehearsed(host_clock, monkeypatch):
    monkeypatch.setattr(chip_smoke, "ASSIGN_SHAPE", (60, 50))
    out = chip_smoke.assignment_check("cpu", "CPU")
    assert [k for k, _ in out["calls"]] == ["warm-up", "capture", "replay"]
