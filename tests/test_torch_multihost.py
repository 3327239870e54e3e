"""The port's multi-process runtime: 2 processes x 4 CPU shards joined by
``torch.distributed`` (gloo) run the point-major BA step across the process
boundary; the twin of tests/test_multihost.py.  The parent compares the
result with the port's in-process 8-shard mesh and with the JAX package's
8-device mesh (in float64 on the reference's degenerate problem:
tests/test_torch_parallel.py's docstring).

Run as a script, this file is one such process:

    python tests/test_torch_multihost.py <rank> <nproc> <port> <outdir>
"""

import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LOCAL_SHARDS = 4
KM = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def seen_by_all(seed, n_cams=5, n_pts=96):
    """A BA problem whose every point is observed by every camera (0.5 px
    noise, ~10% of the rows invalid); the last camera is the fixed one."""
    g = np.random.default_rng(seed)
    pts = (g.uniform(-2, 2, (n_pts, 3)) + [0, 0, 6]).astype(np.float32)
    poses = np.zeros((n_cams, 7), np.float32)
    poses[:, 0], poses[:, 4] = 1.0, 0.3 * np.arange(n_cams)
    cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    xc = pts[pt] + poses[cam, 4:]
    uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320, 500 * xc[:, 1] / xc[:, 2] + 240], 1)
    uv = (uv + g.normal(0, 0.5, uv.shape)).astype(np.float32)
    valid = g.random(len(cam)) < 0.9
    poses0 = poses.copy()
    poses0[:-1, 4:] += (0.05 * g.standard_normal((n_cams - 1, 3))).astype(np.float32)
    pts0 = (pts + 0.05 * g.standard_normal(pts.shape)).astype(np.float32)
    return poses0, pts0, cam, pt, uv, np.ones(len(cam), np.float32), valid


def problems(n_dev):
    """(name, problem, n_opt): the reference test's problem, and one where
    the packages can be held to each other in f32."""
    from multihost_child import make_problem_np
    return (("reference", make_problem_np(n_dev=n_dev), 3), ("seen_by_all", seen_by_all(0), 4))


def run_distributed(mesh, problem, n_opt):
    """One step of ``problem`` over ``mesh``: the layout on every process's
    host, this process's shards, the step, then one gather of the points
    (the result fetch, not part of the step)."""
    import torch
    from asdslam_torch.parallel import dist

    poses0, pts0, cam_idx, pt_idx, uv, inv_s2, valid = problem
    (pts_pm, cam_o, pt_o, uv_o, s2_o, va_o, Pn_pad) = dist.layout_point_major(
        pts0, cam_idx, pt_idx, uv, inv_s2, valid, mesh.size)
    new_poses, new_pts = dist.distributed_ba_step_pm(
        mesh, torch.tensor(poses0), dist.shard_to_mesh(mesh, pts_pm, "data"),
        dist.shard_observations(mesh, cam_o, pt_o, uv_o, s2_o, va_o, Pn_pad, n_opt),
        torch.tensor(KM), n_opt=n_opt)
    return new_poses.cpu().numpy(), mesh.gather(new_pts)[:len(pts0)].cpu().numpy()


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_ba(tmp_path):
    import jax
    from asdslam_torch.parallel import dist as tdist

    assert len(jax.devices()) >= 8

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(i), "2",
                               str(port), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i} failed:\n{outs[i][-3000:]}"

    r0, r1 = (np.load(tmp_path / f"result_{i}.npz") for i in range(2))
    mesh = tdist.make_mesh(2 * LOCAL_SHARDS, "cpu")
    for name, problem, n_opt in problems(2 * LOCAL_SHARDS):
        poses, pts = r0[name + "_poses"], r0[name + "_pts"]
        # both processes hold the same replicated poses and gathered points
        # (measured: equal bit for bit)
        np.testing.assert_allclose(poses, r1[name + "_poses"], atol=1e-6)
        np.testing.assert_allclose(pts, r1[name + "_pts"], atol=1e-6)
        assert np.isfinite(poses).all() and np.isfinite(pts).all()
        # the in-process 8-shard mesh: the same float64 sums, associated
        # per process (the reference's bars; measured: equal bit for bit)
        poses_in, pts_in = run_distributed(mesh, problem, n_opt)
        np.testing.assert_allclose(poses, poses_in, atol=5e-3)
        np.testing.assert_allclose(pts, pts_in, atol=2e-2)
        if name == "seen_by_all":
            # tests/test_torch_parallel.py::test_step_matches_reference's
            # bars (measured 1.6e-5 / 5.9e-5)
            jp, jx = jax_run(problem, n_opt, x64=False)
            np.testing.assert_allclose(poses, jp, atol=2e-4)
            np.testing.assert_allclose(pts, jx, atol=3e-4)
        else:
            # each point seen by one camera: held to the JAX step in float64
            # (tests/test_torch_parallel.py's docstring; its bars)
            jp, jx = jax_run(problem, n_opt, x64=True)
            np.testing.assert_allclose(poses, jp, atol=1e-6)
            np.testing.assert_allclose(pts, jx, atol=5e-6)
    expect = np.arange(6.0).reshape(2, 3).T * LOCAL_SHARDS * (1 + 2)
    np.testing.assert_array_equal(r0["strided_sum"], expect)
    np.testing.assert_array_equal(r1["strided_sum"], expect)
    reduced = sum(n * n * 36 + n * 36 + 2 * n * 6 for _, _, n in problems(1)) + 6
    assert r0["reduced"] == r1["reduced"] == reduced


def jax_run(problem, n_opt, x64):
    """tests/multihost_child.py::run_distributed on the JAX package's
    8-device mesh, with ``n_opt``, in float64 where ``x64``."""
    import jax
    import jax.numpy as jnp
    from asdslam_tpu.parallel import dist as jdist

    (pts_pm, cam_o, pt_o, uv_o, s2_o, va_o, _) = jdist.layout_point_major(*problem[1:], 8)
    with jax.enable_x64(x64):
        f = jnp.float64 if x64 else jnp.float32
        poses, pts = jdist.distributed_ba_step_pm(
            jdist.make_mesh(8), jnp.asarray(problem[0], f), jnp.asarray(pts_pm, f),
            jnp.asarray(cam_o), jnp.asarray(pt_o), jnp.asarray(uv_o, f), jnp.asarray(s2_o, f),
            jnp.asarray(va_o), jnp.asarray(KM, f), n_opt=n_opt)
        return np.asarray(poses), np.asarray(pts)[:len(problem[1])]


def main(argv):
    rank, nproc, port, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed
    from asdslam_torch.parallel import dist

    torch.set_num_threads(1)
    dist.init_multihost(f"localhost:{port}", nproc, rank, backend=None)
    try:
        assert torch.distributed.get_backend() == "gloo"
        mesh = dist.global_mesh(LOCAL_SHARDS, device="cpu")
        assert mesh.size == LOCAL_SHARDS * nproc and mesh.first == LOCAL_SHARDS * rank
        out = {}
        for name, problem, n_opt in problems(mesh.size):
            out[name + "_poses"], out[name + "_pts"] = run_distributed(mesh, problem, n_opt)
        # a strided partial (an einsum's output may be one) reduces as well
        strided = torch.arange(6.0).reshape(2, 3).t() * (rank + 1)
        out["strided_sum"] = mesh.psum([strided] * LOCAL_SHARDS)[0].numpy()
        np.savez(os.path.join(outdir, f"result_{rank}.npz"), reduced=mesh.reduced_elems, **out)
    finally:
        torch.distributed.destroy_process_group()
    print(f"process {rank}: OK")


if __name__ == "__main__":
    main(sys.argv[1:])
