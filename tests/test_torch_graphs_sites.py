"""The reference's remaining ``jax.jit`` sites in the port, each a
module-level ``graphs.captured`` callable beside its call site: the loop
funnel (loop/loop_closing.py), the keyframe pass (backend/local_mapping.py),
relocalization, the staged track and the bootstrap (frontend/tracking.py),
and the BoW descent (loop/vocab.py).

On the CPU the graph path runs through tests/test_torch_graphs.py's fake
graphs (the ``card`` fixture): every site, on seeded inputs of a small
synthetic scene, equals its eager function bit for bit through the warm-up,
the capture and the replays.  A 30-frame System run through the fake graphs
keeps each site under ``graphs.MAX_GRAPHS`` keys (one shape for the
triangulation, at most four for the fuse) and gives the eager CPU run's
trajectory bit for bit.  The padded slots that the keyframe pass takes on
the card equal the live-slot launch on the live slots, give -1 on the
padded ones, and agree with the JAX package's padded functions.  The
``gpu`` test holds every site against ``.eager`` on the card
(chip_smoke.py phase 15's check) at this small size.
"""

import os
import sys

import numpy as np
import pytest
import torch

from asdslam_torch.backend import local_mapping, mapping_kernels
from asdslam_torch.config import SlamConfig
from asdslam_torch.frontend import tracking
from asdslam_torch.geometry import se3
from asdslam_torch.loop import loop_closing, vocab
from asdslam_torch.utils import graphs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402
from test_torch_graphs import SMALL, card  # noqa: E402,F401  (the fixture)

N_PTS = 200        # points of the synthetic scene
P_BLOCK = 256      # rows of a padded map-point block
Q_TRI = 20         # the triangulation's neighbour slots (SlamConfig's default)
LIVE = 3           # live neighbours / fuse pairs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These shapes are too small for intra-op threads to help, and the test
    processes that run side by side would only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return SlamConfig(**SMALL)


def _K(cfg):
    return torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])


class Scene:
    """N_PTS world points in front of camera 0 (the identity pose) and seen
    by cameras 1-3 (translated and slightly turned): each view's pixels,
    levels, descriptors (one unit vector a point, a little noise a view) and
    validity, from one seed."""

    def __init__(self, cfg, seed=0):
        g = np.random.default_rng(seed)
        n = N_PTS
        self.X = np.stack([g.uniform(-2, 2, n), g.uniform(-1.5, 1.5, n),
                           g.uniform(4, 10, n)], 1).astype(np.float32)
        d = g.standard_normal((n, 128)).astype(np.float32)
        self.desc = d / np.linalg.norm(d, axis=1, keepdims=True)
        self.K = _K(cfg)
        self.poses = [se3.pose_pack(*se3.se3_exp(torch.tensor(
            [0.0, 0.03 * c, 0.0, -0.4 * c, 0.05 * c, 0.1 * c])))
            for c in range(4)]
        self.views = [self._view(cfg, g, p) for p in self.poses]

    def _view(self, cfg, g, pose7):
        R, t = (x.numpy() for x in se3.pose_unpack(pose7))
        xc = self.X @ R.T + t
        K = self.K.numpy()
        uv = np.stack([K[0, 0] * xc[:, 0] / xc[:, 2] + K[0, 2],
                       K[1, 1] * xc[:, 1] / xc[:, 2] + K[1, 2]], 1)
        uv = (uv + g.normal(0, 0.3, uv.shape)).astype(np.float32)
        d = self.desc + g.normal(0, 0.02, self.desc.shape).astype(np.float32)
        return dict(uv=uv, desc=(d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
                    level=g.integers(0, cfg.n_levels, N_PTS).astype(np.int32),
                    angle=g.uniform(0, 0.2, N_PTS).astype(np.float32),
                    valid=g.uniform(size=N_PTS) > 0.1)

    def feat(self, c, perm=None):
        """View c's features as tensors (desc, uv, level, valid, angle), rows
        in ``perm``'s order."""
        v = self.views[c]
        p = np.arange(N_PTS) if perm is None else perm
        return tuple(torch.as_tensor(v[k][p]) for k in ("desc", "uv", "level", "valid", "angle"))

    def block(self, c, cfg, rows=P_BLOCK):
        """Camera c's centre's view of the points as a padded map-point block:
        (pos, normal, min_dist, max_dist, valid) of ``rows`` rows."""
        R, t = (x.numpy() for x in se3.pose_unpack(self.poses[c]))
        centre = -R.T @ t
        pc = self.X - centre
        dist = np.linalg.norm(pc, axis=1)
        pad = rows - N_PTS

        def padded(x, fill=0):
            return torch.as_tensor(np.concatenate([x, np.full((pad,) + x.shape[1:], fill,
                                                               x.dtype)]))
        return (padded(self.X), padded((pc / dist[:, None]).astype(np.float32)),
                padded((0.5 * dist).astype(np.float32)), padded((2.0 * dist).astype(np.float32)),
                padded(self.views[c]["valid"], False))

    def block_desc(self, c, rows=P_BLOCK):
        d = np.concatenate([self.views[c]["desc"], np.zeros((rows - N_PTS, 128), np.float32)])
        return torch.as_tensor(d).to(torch.bfloat16)


def _perm(seed):
    return np.random.default_rng(seed).permutation(N_PTS)


def _scales(cfg):
    return torch.tensor(cfg.scale_factors, dtype=torch.float32)


def _inv_s2(cfg):
    return torch.tensor(cfg.inv_level_sigma2, dtype=torch.float32)


def _draws(iters, seed):
    return torch.rand((iters, N_PTS), generator=torch.Generator().manual_seed(seed))


# --------------------------------------------------------------------------- #
# Each site's inputs: (args, kwargs) on the CPU
# --------------------------------------------------------------------------- #
def _global_search(ratio):
    def make(cfg, sc):
        p = _perm(1)
        a, b = sc.feat(0), sc.feat(1, p)
        return (a[0], b[0], a[3], b[3]), dict(max_dist=cfg.match_th_low * 2, ratio=ratio)
    return make


def _sim3(cfg, sc):
    g = np.random.default_rng(2)
    s, R = 1.3, se3.so3_exp(torch.tensor([[0.02, -0.05, 0.01]]))[0].numpy()
    t = np.array([0.3, -0.1, 0.2], np.float32)
    P1 = sc.X
    P2 = (s * P1 @ R.T + t).astype(np.float32)
    out = g.uniform(size=N_PTS) < 0.2
    P2[out] = P2[g.permutation(np.nonzero(out)[0])]
    K = sc.K.numpy()

    def proj(P):
        return np.stack([K[0, 0] * P[:, 0] / P[:, 2] + K[0, 2],
                         K[1, 1] * P[:, 1] / P[:, 2] + K[1, 2]], 1).astype(np.float32)
    lvl1, lvl2 = sc.views[0]["level"], sc.views[1]["level"]
    inv = np.asarray(cfg.inv_level_sigma2, np.float32)
    T = torch.as_tensor
    return ((_draws(60, 3), T(P1), T(P2), T(proj(P1)), T(proj(P2)),
             T(sc.views[0]["valid"]), sc.K, T(9.21 / inv[lvl1]), T(9.21 / inv[lvl2]),
             T(inv[lvl1]), T(inv[lvl2])), dict(min_inliers=cfg.sim3_ransac_min_inliers))


def _loop_block(cfg, sc, c_pose, c_feat, seed):
    """loop_closing.project_search's twelve arguments: the points of view 0
    through camera ``c_pose`` into view ``c_feat``'s (permuted) features."""
    d = sc.feat(c_feat, _perm(seed))
    return ((sc.poses[c_pose], sc.K) + sc.block(0, cfg)[:4] + (sc.block(0, cfg)[4],
            sc.block_desc(0), d[0], d[1], d[3], _scales(cfg)))


def _loop_constants(cfg, radius):
    return dict(radius=radius, bounds=tuple(cfg.undistorted_bounds), max_dist=cfg.match_th_high,
                scale_factor=cfg.scale_factor, n_levels=cfg.n_levels, use_kernel=True)


def _guided(cfg, sc):
    return ((_loop_block(cfg, sc, 1, 1, 4), _loop_block(cfg, sc, 2, 2, 5)),
            _loop_constants(cfg, 10.0))


def _loop_fuse(cfg, sc):
    return _loop_block(cfg, sc, 1, 1, 6), _loop_constants(cfg, cfg.fuse_radius)


def triangulation_inputs(cfg, sc, padded=True):
    """triangulate_neighbors' arguments for view 0 against LIVE neighbour
    views, padded to Q_TRI slots by local_mapping.pad_triangulation_slots
    (``padded``) or the live slots alone."""
    f1 = sc.feat(0)
    feats, free, Rs, ts = [], [], [], []
    for c in range(1, LIVE + 1):
        f = sc.feat(c, _perm(10 + c))
        feats.append(f)
        free.append(f[3].numpy())
        R, t = se3.pose_unpack(sc.poses[c])
        Rs.append(R.numpy())
        ts.append(t.numpy())
    free, Rs, ts = np.stack(free), np.stack(Rs), np.stack(ts)
    if padded:
        feats, free, Rs, ts = local_mapping.pad_triangulation_slots(feats, free, Rs, ts, Q_TRI)
    fmean = 0.5 * (cfg.fx + cfg.fy)
    return ((f1[0], f1[1], f1[2], f1[3], [f[0] for f in feats], [f[1] for f in feats],
             [f[2] for f in feats], torch.as_tensor(free), torch.as_tensor(Rs),
             torch.as_tensor(ts), torch.eye(3), torch.zeros(3), sc.K, _inv_s2(cfg)),
            dict(max_dist=cfg.match_th_low * 2, ratio=0.9, fmean=fmean,
                 min_parallax_cos=cfg.triangulation_min_parallax_cos))


def fuse_inputs(cfg, sc, padded=True):
    """fuse_pairs' arguments for LIVE pairs (view 0's points into views
    1-3) in local_mapping.FUSE_PAIRS slots; ``padded``: every slot
    evaluated (the card's form), else the live pairs alone."""
    Q = local_mapping.FUSE_PAIRS
    blk = sc.block(0, cfg)
    pos, normal, mind, maxd, valid = (torch.stack([x] * Q) for x in blk)
    valid[LIVE:] = False
    desc = torch.stack([sc.block_desc(0)] * Q)
    pose = torch.stack([sc.poses[1 + q % LIVE] for q in range(Q)])
    pose[LIVE:] = torch.tensor([1.0, 0, 0, 0, 0, 0, 0])
    dst = [sc.feat(1 + q, _perm(20 + q)) for q in range(LIVE)]
    n = Q if padded else LIVE
    dst = [dst[q] if q < LIVE else dst[0] for q in range(n)]
    return ((pos, normal, mind, maxd, desc, valid, pose, [f[0] for f in dst],
             [f[1] for f in dst], [f[2] for f in dst], [f[3] for f in dst], sc.K,
             _scales(cfg)),
            dict(width=float(cfg.image_width), height=float(cfg.image_height),
                 scale_factor=cfg.scale_factor, n_levels=cfg.n_levels,
                 fuse_radius=cfg.fuse_radius, max_dist=cfg.match_th_high,
                 n_live=None if padded else LIVE, use_kernel=True))


def _window(cfg, sc):
    a, b = sc.feat(0), sc.feat(1, _perm(7))
    return ((a[0], b[0], a[1], b[1], a[3], b[3]),
            dict(radius=cfg.init_search_window, max_dist=cfg.match_th_low * 2, ratio=0.9,
                 angles_a=a[4], angles_b=b[4], check_rotation=True))


def _two_view(cfg, sc):
    a, b = sc.feat(0), sc.feat(1)
    return ((_draws(cfg.init_ransac_iters, 8), a[1], b[1], a[3] & b[3], sc.K),
            dict(sigma=cfg.init_sigma, min_triangulated=cfg.init_min_triangulated))


def _pnp(cfg, sc):
    f = sc.feat(2)
    chi2 = cfg.reloc_ransac_th2 / _inv_s2(cfg)[f[2].to(torch.int64)]
    return ((_draws(100, 9), torch.as_tensor(sc.X), f[1], f[3], sc.K, chi2),
            dict(min_inliers=cfg.reloc_ransac_min_inliers))


def _pose_only(cfg, sc):
    f = sc.feat(2)
    start = se3.pose_retract(sc.poses[2], torch.tensor([0.01, -0.01, 0.02, 0.05, 0.0, -0.03]))
    return ((start, torch.as_tensor(sc.X), f[1], _inv_s2(cfg)[f[2].to(torch.int64)], f[3],
             sc.K), dict(rounds=cfg.pose_opt_rounds, iters=cfg.pose_opt_iters))


def _motion(cfg, sc):
    p = _perm(12)
    a, b = sc.feat(1), sc.feat(1, p)
    radius = cfg.search_radius_motion * _scales(cfg)[a[2].to(torch.int64)]
    return ((a[0], b[0], a[1] + 2.0, b[1], a[3], b[3], radius, cfg.match_th_high),
            dict(ratio=1.0, pred_level_a=a[2], levels_b=b[2], use_kernel=True))


def _track_block(cfg, sc):
    d = sc.feat(2, _perm(13))
    skip = torch.as_tensor(np.random.default_rng(14).uniform(size=N_PTS) < 0.2)
    blk = sc.block(0, cfg)
    return ((sc.poses[2], sc.K) + blk[:4] + (blk[4], sc.block_desc(0), d[0], d[1], d[3], d[2],
                                              skip, _scales(cfg)),
            dict(radius=cfg.search_radius_local, bounds=tuple(cfg.undistorted_bounds),
                 max_dist=cfg.match_th_high, ratio=0.8, min_view_cos=0.5,
                 scale_factor=cfg.scale_factor, n_levels=cfg.n_levels, use_kernel=True))


def _descend(cfg, sc):
    g = torch.Generator().manual_seed(15)
    levels = [torch.zeros(1, 128)] + [torch.randn(3 ** k, 128, generator=g) for k in (1, 2, 3)]
    return (levels, torch.as_tensor(sc.views[0]["desc"]), 3, 3), {}


# name: (owning module, attribute, inputs); chip_smoke.JIT_SITES names the same
SITES = {
    "loop_search_global": (loop_closing, "_search_global",
                           _global_search(SlamConfig().match_nn_ratio_loop)),
    "loop_sim3": (loop_closing, "_sim3", _sim3),
    "loop_guided": (loop_closing, "_guided_counts", _guided),
    "loop_project_search": (loop_closing, "_project_search", _loop_fuse),
    "triangulate_neighbors": (local_mapping, "_triangulate", triangulation_inputs),
    "fuse_pairs": (local_mapping, "_fuse", fuse_inputs),
    "search_window": (tracking, "_search_window", _window),
    "initialize_two_view": (tracking, "_two_view", _two_view),
    "track_search_global": (tracking, "_search_global", _global_search(0.75)),
    "ransac_pnp": (tracking, "_ransac_pnp", _pnp),
    "pose_only_optimize": (tracking, "_pose_only", _pose_only),
    "motion_search": (tracking, "_motion_search", _motion),
    "project_search": (tracking, "_project_search", _track_block),
    "bow_descend": (vocab, "_descend", _descend),
}


def site_inputs(name, device="cpu"):
    """(the site's captured callable, args, kwargs) with the tensors on
    ``device``."""
    cfg = _cfg()
    module, attr, make = SITES[name]
    args, kwargs = make(cfg, Scene(cfg))
    return getattr(module, attr), chip_smoke.to_device(args, device), \
        chip_smoke.to_device(kwargs, device)


@pytest.fixture
def sites_card(card):
    """The ``card`` fixture with every site's keys cleared before and after."""
    def clear():
        for module, attr, _ in SITES.values():
            getattr(module, attr)._entries.clear()
    clear()
    yield card
    clear()


def test_registry_names_every_site():
    assert set(SITES) == set(chip_smoke.JIT_SITES)
    for name, (module, attr, _) in SITES.items():
        site = getattr(module, attr)
        assert isinstance(site, graphs.Captured) and site.name == name
        assert chip_smoke.JIT_SITES[name][:2] == (module.__name__, attr)


@pytest.mark.parametrize("name", sorted(SITES))
def test_site_through_the_graph_path(sites_card, name):
    """The warm-up, the capture with its first replay, and two replays, each
    bit for bit the eager function's result on the same inputs."""
    site, args, kwargs = site_inputs(name)
    want = site.eager(*args, **kwargs)
    for call in range(4):
        got = site(*args, **kwargs)
        assert chip_smoke.tree_same_bits(got, want), (name, call)
    assert (sites_card["warm"], sites_card["capture"]) == (1, 1)
    assert [s["replays"] for s in site.stats()] == [3]


def test_sites_run_their_function_on_the_cpu():
    for name in SITES:
        site, args, kwargs = site_inputs(name)
        assert chip_smoke.tree_same_bits(site(*args, **kwargs), site.eager(*args, **kwargs))
        assert not site._entries, name


def test_padded_triangulation_equals_the_live_slots():
    cfg = _cfg()
    sc = Scene(cfg)
    (pa, pk), (la, lk) = triangulation_inputs(cfg, sc), triangulation_inputs(cfg, sc, False)
    enc_p, X_p = mapping_kernels.triangulate_neighbors(*pa, **pk)
    enc_l, X_l = mapping_kernels.triangulate_neighbors(*la, **lk)
    assert enc_p.shape == (Q_TRI, N_PTS) and enc_l.shape == (LIVE, N_PTS)
    assert chip_smoke.same_bits(enc_p[:LIVE], enc_l) and chip_smoke.same_bits(X_p[:LIVE], X_l)
    assert (enc_p[LIVE:] == -1).all()
    assert (enc_l >= 0).sum() > 100  # the live slots triangulate


def test_padded_fuse_equals_the_live_pairs():
    cfg = _cfg()
    sc = Scene(cfg)
    (pa, pk), (la, lk) = fuse_inputs(cfg, sc), fuse_inputs(cfg, sc, False)
    enc_p = mapping_kernels.fuse_pairs(*pa, **pk)
    enc_l = mapping_kernels.fuse_pairs(*la, **lk)
    assert enc_p.shape == enc_l.shape == (local_mapping.FUSE_PAIRS, P_BLOCK)
    assert chip_smoke.same_bits(enc_p, enc_l)
    assert (enc_p[LIVE:] == -1).all() and (enc_p[:LIVE] >= 0).sum() > 100


def test_padded_forms_against_the_reference():
    """The padded triangulation and fuse against the JAX package's padded
    functions on the same inputs: indices exact in every slot; triangulated
    points within tests/test_torch_mapping.py's bar (1e-4 relative where
    the rays part by more than ~5.7 degrees, 3e-3 below)."""
    import jax.numpy as jnp
    from asdslam_tpu.backend import mapping_kernels as jmk

    cfg = _cfg()
    sc = Scene(cfg)

    def j(x):
        if isinstance(x, list):
            return jnp.stack([jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16
                                          else v.numpy()) for v in x])
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy(), jnp.bfloat16)
        return jnp.asarray(x.numpy())

    args, kw = triangulation_inputs(cfg, sc)
    enc, X = mapping_kernels.triangulate_neighbors(*args, **kw)
    jenc, jX = (np.asarray(v) for v in jmk.triangulate_neighbors(*map(j, args), **kw))
    np.testing.assert_array_equal(enc.numpy(), jenc.astype(np.int64))
    both = enc.numpy() >= 0
    assert both.sum() > 100
    c2 = -np.einsum("qji,qj->qi", args[8].numpy(), args[9].numpy())[:, None, :]
    r1, r2 = jX, jX - c2
    cosp = (r1 * r2).sum(-1) / (np.linalg.norm(r1, axis=-1) * np.linalg.norm(r2, axis=-1))
    wide = both & (cosp < 0.995)
    np.testing.assert_allclose(X.numpy()[wide], jX[wide], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(X.numpy()[both], jX[both], rtol=3e-3, atol=1e-4)

    args, kw = fuse_inputs(cfg, sc)
    kw = {k: v for k, v in kw.items() if k not in ("n_live", "use_kernel")}
    enc = mapping_kernels.fuse_pairs(*args, **kw)
    jenc = np.asarray(jmk.fuse_pairs(*map(j, args), **kw))
    np.testing.assert_array_equal(enc.numpy(), jenc.astype(np.int64))


def _system_run(cfg, frames):
    from asdslam_torch.models import patch_descriptor
    from asdslam_torch.system import System

    system = System(cfg, descriptor_fn=patch_descriptor.apply, do_loop_closing=True,
                    device="cpu")
    for i, f in enumerate(frames):
        system.track_monocular(f, i)
    system.finish()
    return system


@pytest.fixture(scope="module")
def eager_cpu_run():
    """The 30-frame synchronous SMALL System on the CPU path (live slots),
    and its frames."""
    from asdslam_torch.io import synthetic

    cfg = _cfg().replace(pipelined_tracking=False, async_mapping=False)
    frames, _ = synthetic.render_sequence(_K(cfg), 30, cfg.image_height, cfg.image_width,
                                          step=0.25, turn=0.004, device="cpu")
    frames = [(f * 255.0).clamp(0, 255).to(torch.uint8) for f in frames]
    return cfg, frames, _system_run(cfg, frames)


def test_system_keys_and_trajectory(sites_card, eager_cpu_run):
    """The same 30 frames with every capture site on the (fake) graph path:
    the keyframe pass takes its padded shapes, each site keeps at most
    MAX_GRAPHS keys (the triangulation one shape, the fuse at most four),
    and the frame and keyframe trajectories are the CPU path's bit for
    bit."""
    cfg, frames, want = eager_cpu_run
    got = _system_run(cfg, frames)
    assert got.store.n_kf >= 3
    shapes = {}
    for name, (module, attr, _) in SITES.items():
        entries = getattr(module, attr)._entries
        assert len(entries) <= graphs.MAX_GRAPHS, name
        shapes[name] = len({key[0] for key in entries})
    assert shapes["triangulate_neighbors"] == 1 and 1 <= shapes["fuse_pairs"] <= 4, shapes
    assert shapes["search_window"] >= 1 and shapes["initialize_two_view"] >= 1, shapes
    for a, b in ((got.frame_trajectory(), want.frame_trajectory()),
                 (got.keyframe_trajectory(), want.keyframe_trajectory())):
        assert len(a) == len(b) and all(fa == fb and pa.tobytes() == pb.tobytes()
                                        for (fa, pa), (fb, pb) in zip(a, b))


@pytest.mark.gpu
def test_sites_equal_eager_on_the_card():
    """Every site on the card (chip_smoke.py phase 15's check_site): the
    warm-up, the capture and a replay, each bit for bit ``.eager``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from asdslam_torch import kernels

    kernels.build()
    for name in SITES:
        site, args, kwargs = site_inputs(name, "cuda")
        chip_smoke.check_site(name, site, args, kwargs)
