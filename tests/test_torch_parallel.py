"""The port's multi-device path (``asdslam_torch/parallel/``) against the JAX
package's (``asdslam_tpu/parallel/``): twins of tests/test_parallel.py on a
CPU mesh of 8 shards, the point-major layout byte for byte, the BA step
against the JAX step on the 8-device CPU mesh, the batched tracking step,
and the loop closer's mesh global BA in a ``System``.

How the BA step is held to the JAX package's: in the reference's test
problems every point is seen by one camera only (cam = o % 4, pt = o % 64),
so its depth is unobservable, H_pp is nearly singular, and an f32 step is
set by rounding (the JAX package's f32 step differs from its own float64
step by 0.10-0.32 in the poses).  The port computes the step in float64
(dist.py's docstring), so on those problems it is held to the JAX step run
in float64, and to the JAX package's f32 step on a problem where every
point is seen by every camera.
"""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asdslam_tpu.backend import ba as jba
from asdslam_tpu.parallel import dist as jdist
from asdslam_torch.backend import ba as tba
from asdslam_torch.parallel import dist as tdist
from asdslam_torch.parallel import multi_seq as tmulti
from multihost_child import make_problem_np
from test_torch_multihost import seen_by_all

KM = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_problem(seed, n_cams=4, n_pts=64, n_dev=8):
    """tests/test_parallel.py::make_problem (jax.random) as numpy arrays."""
    from test_parallel import make_problem
    _, _, poses0, pts0, obs = make_problem(jax.random.PRNGKey(seed), n_cams, n_pts, n_dev)
    return (np.asarray(poses0), np.asarray(pts0)) + tuple(np.asarray(x) for x in obs)


def tobs(prob):
    return tba.Obs(*(torch.tensor(x) for x in prob[2:]))


def jobs(prob):
    return jba.Obs(*(jnp.asarray(x) for x in prob[2:]))


def reproj_rmse(poses, pts, obs):
    r, _, _, _ = tba._project_residuals(torch.as_tensor(poses), torch.as_tensor(pts), obs,
                                        torch.as_tensor(KM))
    return float(torch.sqrt(torch.mean(torch.sum(r * r, dim=1))))


# --------------------------------------------------------------------------- #
# Twins of tests/test_parallel.py::TestDistributedBA
# --------------------------------------------------------------------------- #
def test_step_reduces_error():
    mesh = tdist.make_mesh(8, "cpu")
    prob = reference_problem(0)
    obs = tobs(prob)
    e0 = reproj_rmse(prob[0], prob[1], obs)
    poses, pts = prob[0], prob[1]
    for _ in range(3):
        poses, pts = tdist.distributed_ba_step(mesh, poses, pts, obs, None, KM, n_opt=3)
    e1 = reproj_rmse(poses, pts, obs)
    assert e1 < e0 * 0.05, (e0, e1)
    np.testing.assert_allclose(poses[3].numpy(), prob[0][3], atol=1e-7)


def test_matches_single_device_semantics():
    """One step on 8 shards against one on a single shard, at the
    reference's bars: the camera blocks are summed in another order
    (measured: equal bit for bit, the step being float64 inside)."""
    prob = reference_problem(1)
    p8, x8 = tdist.distributed_ba_step(tdist.make_mesh(8, "cpu"), prob[0], prob[1], tobs(prob),
                                       None, KM, n_opt=3)
    p1, x1 = tdist.distributed_ba_step(tdist.make_mesh(1, "cpu"), prob[0], prob[1], tobs(prob),
                                       None, KM, n_opt=3)
    np.testing.assert_allclose(p8.numpy(), p1.numpy(), atol=5e-3)
    np.testing.assert_allclose(x8.numpy(), x1.numpy(), atol=2e-2)


def test_comm_payload_independent_of_point_count():
    """The point-major contract: what ``psum`` reduces per step is the four
    camera blocks, whatever the point count (the reference reads its
    all-reduces from the compiled program; the port counts them)."""
    n_opt = 3

    def reduced(n_pts):
        mesh = tdist.make_mesh(8, "cpu")
        prob = reference_problem(0, n_pts=n_pts)
        tdist.distributed_ba_step(mesh, prob[0], prob[1], tobs(prob), None, KM, n_opt=n_opt)
        return mesh.reduced_elems

    e_small, e_big = reduced(64), reduced(1024)
    assert e_small == e_big == n_opt * n_opt * 36 + n_opt * 36 + 2 * n_opt * 6
    assert e_small <= 4 * (n_opt * n_opt * 36 + n_opt * 36 + 2 * n_opt * 6)


def _layout_inputs(seed=0, Pn=37, O=500):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((Pn, 3)).astype(np.float32)
    pt_idx = rng.integers(0, Pn, O).astype(np.int32)
    cam_idx = rng.integers(0, 5, O).astype(np.int32)
    uv = rng.standard_normal((O, 2)).astype(np.float32)
    s2 = rng.uniform(0.5, 2.0, O).astype(np.float32)
    valid = rng.random(O) < 0.9
    return pts, cam_idx, pt_idx, uv, s2, valid


def test_layout_point_major_roundtrip():
    """Every valid observation survives the re-layout, lands on the shard
    owning its point, and reindexes consistently."""
    pts, cam_idx, pt_idx, uv, s2, valid = _layout_inputs()
    Pn, n_dev = len(pts), 8
    pts_pm, cam_o, pt_o, uv_o, s2_o, va_o, Pn_pad = tdist.layout_point_major(
        pts, cam_idx, pt_idx, uv, s2, valid, n_dev)
    assert Pn_pad % n_dev == 0 and Pn_pad >= Pn
    np.testing.assert_allclose(pts_pm[:Pn], pts)
    Pl = Pn_pad // n_dev
    Ol = len(cam_o) // n_dev
    seen = []
    for d in range(n_dev):
        sl = slice(d * Ol, (d + 1) * Ol)
        v = va_o[sl]
        assert (pt_o[sl][v] >= 0).all() and (pt_o[sl][v] < Pl).all()
        glob = pt_o[sl][v] + d * Pl
        assert ((glob // Pl) == d).all()
        seen.extend(zip(glob.tolist(), cam_o[sl][v].tolist(), uv_o[sl][v][:, 0].tolist()))
    orig = list(zip(pt_idx[valid].tolist(), cam_idx[valid].tolist(),
                    uv[valid][:, 0].tolist()))
    assert sorted(seen) == sorted(orig)


def test_dp_descriptors():
    """ASDNet split over 8 shards against the whole batch (the port's and the
    JAX package's), at the reference's bar."""
    from asdslam_tpu.models import asdnet as jnet
    from asdslam_torch.models import asdnet as tnet

    params = jnet.init_params(jax.random.PRNGKey(0))
    patches = np.random.default_rng(1).uniform(size=(64, 32, 32)).astype(np.float32)
    fn = tdist.dp_descriptor_fn(params, tdist.make_mesh(8, "cpu"))
    d = fn(torch.as_tensor(patches)).numpy()
    net = tnet.ASDNet()
    net.load_state_dict(tnet.params_from_jax(params))
    with torch.no_grad():
        whole = net(torch.as_tensor(patches)).numpy()
    np.testing.assert_allclose(d, whole, atol=2e-2)
    np.testing.assert_allclose(d, np.asarray(jnet.apply(params, jnp.asarray(patches))),
                               atol=2e-2)
    with pytest.raises(ValueError, match="not divisible"):
        fn(torch.as_tensor(patches[:60]))


# --------------------------------------------------------------------------- #
# Against the JAX package
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_layout_point_major_equals_reference(n_dev):
    args = _layout_inputs(seed=n_dev)
    for a, b in zip(tdist.layout_point_major(*args, n_dev),
                    jdist.layout_point_major(*args, n_dev)):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        else:
            assert a == b


@pytest.mark.parametrize("seed", [0, 1])
def test_step_matches_reference(seed):
    """One step on 8 shards, the port's and the JAX package's on its
    8-device mesh, both in f32 out.  Measured: poses 6.5e-6-1.7e-5, points
    4.0e-5-7.5e-5 apart (steps of 0.09-0.15 in the poses)."""
    prob = seen_by_all(seed)
    jp, jx = jdist.distributed_ba_step(jdist.make_mesh(8), jnp.asarray(prob[0]),
                                       jnp.asarray(prob[1]), jobs(prob), None,
                                       jnp.asarray(KM), n_opt=4)
    tp, tx = tdist.distributed_ba_step(tdist.make_mesh(8, "cpu"), prob[0], prob[1],
                                       tobs(prob), None, KM, n_opt=4)
    assert float(np.abs(tp.numpy() - prob[0]).max()) > 0.05  # it moved
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-4)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=3e-4)


def jax_step_x64(problem, n_dev, n_opt):
    """One JAX point-major step in float64 on its ``n_dev``-device mesh."""
    layout = jdist.layout_point_major(*problem[1:], n_dev)
    with jax.enable_x64(True):
        f = jdist.make_pm_step(jdist.make_mesh(n_dev), n_opt, 1e-4)
        f64 = [jnp.asarray(x, jnp.float64) for x in (problem[0], layout[0], layout[3],
                                                     layout[4], KM)]
        jp, jx = f(f64[0], f64[1], jnp.asarray(layout[1]), jnp.asarray(layout[2]), f64[2],
                   f64[3], jnp.asarray(layout[5]), f64[4])
        return np.asarray(jp), np.asarray(jx)[:len(problem[1])]


@pytest.mark.parametrize("problem", ["multihost_child", "key0", "key1"])
def test_step_matches_reference_float64(problem):
    """The reference's own (degenerate) problems: the port's step (float64
    inside, f32 out) on 8 shards against the JAX package's step run in
    float64 on its 8-device mesh.  Measured: poses 1.8e-8-3.0e-8, points
    2.4e-7-4.8e-7 apart (the f32 rounding of the result)."""
    prob = (make_problem_np() if problem == "multihost_child"
            else reference_problem(int(problem[-1])))
    jp, jx = jax_step_x64(prob, 8, 3)
    tp, tx = tdist.distributed_ba_step(tdist.make_mesh(8, "cpu"), prob[0], prob[1], tobs(prob),
                                       None, KM, n_opt=3)
    assert tp.dtype == tx.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-6)
    np.testing.assert_allclose(tx.numpy(), jx, atol=5e-6)


def test_step_bitwise_run_to_run():
    prob = seen_by_all(2)
    runs = [tdist.distributed_ba_step(tdist.make_mesh(4, "cpu"), prob[0], prob[1], tobs(prob),
                                      None, KM, n_opt=4) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# Twin of tests/test_parallel.py::TestMultiSequence
# --------------------------------------------------------------------------- #
def _stack_seqs(items):
    """Per-sequence (nested) tuples of tensors -> one with a leading axis."""
    if isinstance(items[0], tuple):
        return type(items[0])(*(_stack_seqs([it[j] for it in items])
                                for j in range(len(items[0]))))
    return torch.stack(items)


def _assert_trees_equal(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif a is None:  # a step result's stamps when off
        assert b is None
    else:
        assert torch.equal(a, b)


def _tiny_dp_case(device):
    """The reference test's shape and inputs (4 sequences, random images,
    random state), made from a seed, on ``device``."""
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.frontend import extractor as text
    from asdslam_torch.frontend import track_step as tts
    from asdslam_torch.geometry import se3
    from asdslam_torch.models import asdnet as tnet

    cfg = SlamConfig(image_height=96, image_width=128, n_features=128, n_levels=2, fx=100.0,
                     fy=100.0, cx=64.0, cy=48.0, local_ba_max_points=64)
    extract = text.make_extractor(cfg, tnet.ASDNet().to(device))
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    g = np.random.default_rng(1)
    B, N, P = 4, cfg.n_features, cfg.local_ba_max_points

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    imgs = t(g.uniform(size=(B, cfg.image_height, cfg.image_width)))
    ident = se3.pose_identity(device=device)[None].repeat(B, 1)
    feat0 = _stack_seqs([extract(imgs[b]) for b in range(B)])

    def block(n, fields):
        desc = g.normal(size=(B, n, 128))
        out = dict(pos=t(g.uniform(-2, 2, (B, n, 3)) + [0, 0, 6]),
                   normal=t(np.tile([0.0, 0.0, -1.0], (B, n, 1))),
                   min_dist=t(np.full((B, n), 0.5)), max_dist=t(np.full((B, n), 50.0)),
                   desc=t(desc / np.linalg.norm(desc, axis=-1, keepdims=True)),
                   valid=t(np.ones((B, n)), torch.bool))
        return [out[f] for f in fields]

    state = (ident, ident, feat0, tts.GeomBlock(*block(N, tts.GeomBlock._fields)),
             tts.PointBlock(*block(P, tts.PointBlock._fields)))
    return cfg, K, extract, imgs, state


def _check_dp_track_step(device):
    """4 sequences over 4 shards: each sequence is the single-sequence step
    on its inputs, bit for bit, and nothing is reduced."""
    from asdslam_torch.frontend import track_step as tts

    cfg, K, extract, imgs, state = _tiny_dp_case(device)
    mesh = tdist.make_mesh(4, device)
    feats, res = tmulti.make_dp_track_step(cfg, K, extract, mesh)(imgs, *state)
    assert res.pose.shape == (4, 7) and torch.isfinite(res.pose).all()
    assert mesh.reduced_elems == 0
    single = tts.make_track_step(cfg, K, extract, device=device)
    take = tmulti._take
    for b in range(4):
        f1, r1 = single(imgs[b], *(take(x, b, device) for x in state))
        _assert_trees_equal(take(feats, b, device), f1)
        _assert_trees_equal(take(res, b, device), r1)
    return cfg, K, extract, imgs, state


def test_dp_track_step_runs():
    cfg, K, extract, imgs, state = _check_dp_track_step("cpu")
    mesh = tdist.make_mesh(4, "cpu")
    step = tmulti.make_dp_track_step(cfg, K, extract, mesh)
    with pytest.raises(ValueError, match="do not split"):
        step(imgs[:3], *(tmulti._take(x, slice(0, 3), "cpu") for x in state))
    # an extractor per device, for shards on distinct cards
    per_device = tmulti.make_dp_track_step(cfg, K, {torch.device("cpu"): extract}, mesh)
    _assert_trees_equal(per_device(imgs, *state), step(imgs, *state))


def test_shard_to_mesh():
    """"data" splits the leading axis into this process's blocks, None
    replicates; an axis the mesh size does not divide, or another spec,
    raises."""
    mesh = tdist.Mesh(["cpu"] * 2, size=6, first=2)  # shards 2 and 3 of 6
    x = np.arange(12 * 2).reshape(12, 2)
    blocks = tdist.shard_to_mesh(mesh, x, "data")
    assert [b.tolist() for b in blocks] == [x[4:6].tolist(), x[6:8].tolist()]
    assert all(torch.equal(r, torch.as_tensor(x)) for r in tdist.shard_to_mesh(mesh, x, None))
    with pytest.raises(ValueError, match="not divisible"):
        tdist.shard_to_mesh(mesh, x[:10], "data")
    with pytest.raises(ValueError, match="spec"):
        tdist.shard_to_mesh(mesh, x, "model")


@pytest.mark.gpu
def test_dp_steps_on_cuda():
    """On the card: the batched tracking step as on the CPU (the masked-NN
    kernel launched three times per sequence), and the BA step over 4
    shards on cuda:0 against the port's CPU result within the bars of
    test_matches_single_device_semantics, bitwise run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from asdslam_torch.ops import masked_nn as k1

    before = k1.masked_nn.launches
    _check_dp_track_step("cuda")
    assert k1.masked_nn.launches - before == 2 * 3 * 4  # the batched and the single steps
    prob = reference_problem(1)
    cpu = tdist.distributed_ba_step(tdist.make_mesh(4, "cpu"), prob[0], prob[1], tobs(prob),
                                    None, KM, n_opt=3)
    runs = [tdist.distributed_ba_step(tdist.make_mesh(4, "cuda"), prob[0], prob[1], tobs(prob),
                                      None, KM, n_opt=3) for _ in range(2)]
    for a, b in zip(*runs):
        assert a.is_cuda and torch.equal(a, b)
    np.testing.assert_allclose(runs[0][0].cpu().numpy(), cpu[0].numpy(), atol=5e-3)
    np.testing.assert_allclose(runs[0][1].cpu().numpy(), cpu[1].numpy(), atol=2e-2)


def test_dp_track_step_against_reference():
    """4 sequences of the synthetic corridor (sequence b's frame scaled by
    1 - 0.05 b) through the port's and the JAX package's batched steps on
    4-shard meshes, from each side's frame-0 state: each port sequence is
    its single step bit for bit, and against the JAX package the bars of
    tests/test_torch_track.py hold: keypoints shared by (uv, level) >= 98.5%
    (measured 98.96-99.31%), poses within 5e-3 (measured 5.8e-4-2.6e-3)."""
    from asdslam_tpu.config import SlamConfig as JConfig
    from asdslam_tpu.frontend import extractor as jext
    from asdslam_tpu.frontend import track_step as jts
    from asdslam_tpu.io import synthetic as jsyn
    from asdslam_tpu.models import asdnet as jnet
    from asdslam_tpu.parallel import multi_seq as jmulti
    from asdslam_torch.config import SlamConfig as TConfig
    from asdslam_torch.frontend import extractor as text
    from asdslam_torch.frontend import track_step as tts
    from asdslam_torch.geometry import se3 as tse3
    from asdslam_torch.models import asdnet as tnet
    from test_torch_track import CFG, K, STEP, TURN, WEIGHTS, _geom, _identity_map

    B = 4
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    frames, poses = jsyn.render_sequence(jnp.asarray(K), 2, 240, 320, step=STEP, turn=TURN)
    f0, f1 = (np.asarray(frames[i]) for i in range(2))
    imgs = np.stack([np.clip(f1 * (1 - 0.05 * b) * 255.0, 0, 255).astype(np.uint8)
                     for b in range(B)])
    img0 = np.clip(f0 * 255.0, 0, 255).astype(np.uint8)
    with open(WEIGHTS, "rb") as f:
        params = pickle.load(f)
    jx = jext.make_extractor(jcfg, lambda p: jnet.apply(params, p, compute_dtype=jnp.float32))
    net = tnet.ASDNet()
    net.load_state_dict(tnet.load_weights(WEIGHTS))
    tx = text.make_extractor(tcfg, lambda p: net(p, compute_dtype=torch.float32))
    jf0 = jx(jnp.asarray(img0).astype(jnp.float32) / 255.0)
    tf0 = tx(torch.tensor(img0).to(torch.float32) / 255.0)

    Pc = CFG["local_ba_max_points"]
    jg = _geom((np.asarray(jf0.uv), np.asarray(jf0.level), np.asarray(jf0.valid)))
    tg = _geom((tf0.uv.numpy(), tf0.level.numpy(), tf0.valid.numpy()))
    rows = np.nonzero(np.asarray(jf0.valid))[0][:Pc]

    def pad(x):
        out = np.zeros((Pc,) + x.shape[1:], x.dtype)
        out[:len(rows)] = x[rows]
        return out

    cand = [pad(x) for x in jg[:4]] + [pad(np.asarray(jf0.desc)), pad(jg[4])]
    vel = tse3.pose_pack(*tse3.se3_exp(torch.tensor([0.0, TURN, 0.0, 0.0, 0.0, -STEP]))).numpy()
    pose = np.float32([1, 0, 0, 0, 0, 0, 0])

    def tile(x):
        return np.repeat(np.asarray(x)[None], B, axis=0)

    jstep = jmulti.make_dp_track_step(jcfg, jnp.asarray(K), jx, jdist.make_mesh(B))
    jfeat, jres = jstep(jnp.asarray(imgs), jnp.asarray(tile(pose)), jnp.asarray(tile(vel)),
                        type(jf0)(*(jnp.asarray(tile(x)) for x in jf0)),
                        jts.GeomBlock(*(jnp.asarray(tile(x)) for x in jg)),
                        jts.PointBlock(*(jnp.asarray(tile(x)) for x in cand)))
    mesh = tdist.make_mesh(B, "cpu")
    tstate = (torch.tensor(tile(pose)), torch.tensor(tile(vel)),
              text.FrameFeatures(*(torch.tensor(tile(x.numpy())) for x in tf0)),
              tts.GeomBlock(*(torch.tensor(tile(x)) for x in tg)),
              tts.PointBlock(*(torch.tensor(tile(x)) for x in cand)))
    tfeat, tres = tmulti.make_dp_track_step(tcfg, torch.tensor(K), tx, mesh)(
        torch.tensor(imgs), *tstate)
    assert mesh.reduced_elems == 0
    single = tts.make_track_step(tcfg, torch.tensor(K), tx, device="cpu")
    take = tmulti._take
    for b in range(B):
        f1b, r1b = single(torch.tensor(imgs[b]), *(take(x, b, "cpu") for x in tstate))
        _assert_trees_equal(take(tfeat, b, "cpu"), f1b)
        _assert_trees_equal(take(tres, b, "cpu"), r1b)
        jfb = type(jf0)(*(np.asarray(x)[b] for x in jfeat))
        _, share = _identity_map(jfb, take(tfeat, b, "cpu"))
        assert share >= 0.985, f"sequence {b}: keypoints shared {share}"
        dpose = float(np.abs(np.asarray(jres.pose)[b] - tres.pose[b].numpy()).max())
        assert dpose <= 5e-3, f"sequence {b}: poses differ by {dpose}"
        assert float(np.abs(np.asarray(poses[1]) - tres.pose[b].numpy()).max()) < 0.05


# --------------------------------------------------------------------------- #
# Twin of tests/test_parallel.py::TestSystemMeshGBA, and the two packages'
# mesh global BA on one map
# --------------------------------------------------------------------------- #
MESH_CFG = dict(n_features=400, n_levels=3, image_width=256, image_height=192, fx=200.0,
                fy=200.0, cx=128.0, cy=96.0, min_match_count=60, local_ba_max_points=1024,
                local_ba_max_obs=4096, max_keyframes=32, max_map_points=8192)


@pytest.fixture(scope="module")
def mesh_system():
    """A port System at the reference test's shape and sequence, with
    cfg.n_devices = 2, after finish()."""
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.io import synthetic
    from asdslam_torch.models import patch_descriptor
    from asdslam_torch.system import System

    cfg = SlamConfig(**MESH_CFG, n_devices=2)
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, _ = synthetic.render_sequence(K, n_frames=14, height=cfg.image_height,
                                          width=cfg.image_width, step=0.3, turn=0.01,
                                          device="cpu")
    slam = System(cfg, descriptor_fn=patch_descriptor.apply, do_loop_closing=True,
                  device="cpu")
    for i in range(frames.shape[0]):
        slam.track_monocular(frames[i], i)
    slam.finish()
    assert slam.store.n_kf >= 3
    return slam


def _closer(lc, n_devices):
    """A loop closer with ``n_devices`` over a copy of ``lc``'s store, with a
    live tracer."""
    from asdslam_torch.loop.loop_closing import LoopCloser
    from asdslam_torch.utils.tracing import Tracer

    out = LoopCloser(lc.cfg.replace(n_devices=n_devices), lc.K, copy.deepcopy(lc.store),
                     device="cpu")
    out.tracer = Tracer()
    return out


def test_system_gba_mesh_size_invariant(mesh_system):
    """Loop closers with n_devices 2 (the System's) and 8 over copies of the
    System's map: _global_ba routes through _global_ba_mesh under its span,
    and the result is mesh-size-invariant within the reference's bars
    (measured: equal bit for bit)."""
    assert mesh_system.loop_closer.cfg.n_devices == 2
    lc2, lc8 = (_closer(mesh_system.loop_closer, n) for n in (2, 8))
    s2, s8 = lc2.store, lc8.store
    n = s2.n_kf
    pre = s2.kf_pose[:n].copy()
    np.testing.assert_array_equal(pre, s8.kf_pose[:n])
    for lc in (lc2, lc8):
        lc._global_ba()
        assert list(lc.tracer.spans) == ["gba_mesh"] and lc.tracer.spans["gba_mesh"].count == 1
    assert not np.allclose(pre, s2.kf_pose[:n])  # it optimized
    assert np.isfinite(s2.kf_pose[:n]).all() and np.isfinite(s2.mp_pos[:s2.n_mp]).all()
    np.testing.assert_allclose(s2.kf_pose[:n], s8.kf_pose[:n], atol=2e-4)
    m = s2.mp_valid[:s2.n_mp]
    np.testing.assert_allclose(s2.mp_pos[:s2.n_mp][m], s8.mp_pos[:s8.n_mp][m], atol=2e-3)


def test_mesh_gba_matches_reference(mesh_system, tmp_path):
    """The System's map exported with save_visual_map (byte-identical in
    both packages), imported by each package, and each package's loop
    closer with n_devices 2 runs _global_ba on it (the port's step in
    float64, the JAX package's in f32).  Measured: keyframe poses 6.0e-8
    apart; points 4.9e-6 within 4 units of the origin, and 2.3e-3 (1.2e-6
    of its distance) on one point 2018 units out.  Bars: poses 1e-5,
    points 1e-5 + 1e-5 of the coordinate."""
    from asdslam_tpu.config import SlamConfig as JConfig
    from asdslam_tpu.loop.loop_closing import LoopCloser as JLoopCloser
    from asdslam_tpu.mapping import persistence as jper
    from asdslam_tpu.mapping.map_store import MapStore as JStore
    from asdslam_torch.loop.loop_closing import LoopCloser as TLoopCloser
    from asdslam_torch.mapping import persistence as tper
    from asdslam_torch.mapping.map_store import MapStore as TStore

    src = mesh_system
    cfg = src.cfg
    path = str(tmp_path / "mesh.map")
    tper.save_visual_map(tper.export_map(src.store, cfg, cfg.covis_weight_posegraph), path)
    K = np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]], np.float32)
    stores = []
    for Store, per, make in (
            (JStore, jper, lambda st: JLoopCloser(JConfig(**MESH_CFG, n_devices=2),
                                                  jnp.asarray(K), st)),
            (TStore, tper, lambda st: TLoopCloser(cfg, torch.tensor(K), st, device="cpu"))):
        store = Store(cfg.max_keyframes, cfg.max_map_points, cfg.n_features,
                      cfg.max_obs_per_point)
        kw = {} if per is jper else dict(device="cpu")
        per.import_map(per.load_visual_map(path), store, cfg.scale_factors, **kw)
        make(store)._global_ba()
        stores.append(store)
    js, ts = stores
    n = ts.n_kf
    assert n == js.n_kf == src.store.n_kf and ts.n_mp == js.n_mp
    loaded = TStore(cfg.max_keyframes, cfg.max_map_points, cfg.n_features,
                    cfg.max_obs_per_point)
    tper.import_map(tper.load_visual_map(path), loaded, cfg.scale_factors, device="cpu")
    assert float(np.abs(ts.kf_pose[:n] - loaded.kf_pose[:n]).max()) > 1e-4  # it optimized
    np.testing.assert_allclose(ts.kf_pose[:n], js.kf_pose[:n], atol=1e-5)
    m = ts.mp_valid[:ts.n_mp]
    np.testing.assert_array_equal(m, js.mp_valid[:js.n_mp])
    np.testing.assert_allclose(ts.mp_pos[:ts.n_mp][m], js.mp_pos[:js.n_mp][m], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n_pts", [64, 1024])
def test_chip_smoke_problem_is_the_reference(n_pts):
    """chip_smoke.py's phase 11 keeps its own copy of
    tests/multihost_child.py::make_problem_np: the same arrays, byte for
    byte."""
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    for a, b in zip(chip_smoke.make_problem_np(n_pts=n_pts), make_problem_np(n_pts=n_pts)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
