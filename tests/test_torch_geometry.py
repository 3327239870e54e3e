"""Parity of the port's SE(3) and small-solve functions
(asdslam_torch.geometry.se3, asdslam_torch.estimators.linalg) with the JAX
package on the same numpy inputs.  f32 geometry: 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from asdslam_tpu.estimators import linalg as jlinalg
from asdslam_tpu.geometry import se3 as jse3
from asdslam_torch.estimators import linalg as tlinalg
from asdslam_torch.geometry import se3 as tse3

TOL = 1e-5


def _tangents(seed, n=64):
    g = np.random.default_rng(seed)
    xi = g.normal(scale=0.8, size=(n, 6)).astype(np.float32)
    xi[:8, :3] *= 1e-5        # small-angle branch
    xi[8:12, :3] = 0.0         # exactly zero rotation
    axis = g.normal(size=(4, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    xi[12:16, :3] = (axis * (np.pi - 1e-4)).astype(np.float32)  # near pi
    return xi


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_exp_log_pack(seed):
    xi = _tangents(seed)
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    Rt, tt = tse3.se3_exp(torch.tensor(xi))
    _close(Rj, Rt)
    _close(tj, tt)
    _close(jse3.so3_exp(jnp.asarray(xi[:, :3])), tse3.so3_exp(torch.tensor(xi[:, :3])))
    R = np.asarray(Rj)
    t = np.asarray(tj)
    _close(jse3.so3_log(jnp.asarray(R)), tse3.so3_log(torch.tensor(R)), 1e-4)
    _close(jse3.se3_log(jnp.asarray(R), jnp.asarray(t)),
           tse3.se3_log(torch.tensor(R), torch.tensor(t)), 1e-4)
    pj = jse3.pose_pack(jnp.asarray(R), jnp.asarray(t))
    pt = tse3.pose_pack(torch.tensor(R), torch.tensor(t))
    _close(pj, pt)
    Ruj, _ = jse3.pose_unpack(pj)
    Rut, _ = tse3.pose_unpack(torch.tensor(np.asarray(pj)))
    _close(Ruj, Rut)
    _close(jse3.hat(jnp.asarray(xi[:, :3])), tse3.hat(torch.tensor(xi[:, :3])))


def test_compose_inverse_retract_quat():
    g = np.random.default_rng(3)
    xi = _tangents(3, 32)
    p = np.asarray(jse3.pose_pack(*jse3.se3_exp(jnp.asarray(xi))))
    d = (g.normal(scale=0.1, size=(32, 6))).astype(np.float32)
    _close(jse3.pose_retract(jnp.asarray(p), jnp.asarray(d)),
           tse3.pose_retract(torch.tensor(p), torch.tensor(d)))
    Ra, ta = jse3.pose_unpack(jnp.asarray(p))
    Rb, tb = jse3.pose_unpack(jnp.asarray(p[::-1].copy()))
    Rat, tat = tse3.pose_unpack(torch.tensor(p))
    Rbt, tbt = tse3.pose_unpack(torch.tensor(p[::-1].copy()))
    for a, b in zip(jse3.compose(Ra, ta, Rb, tb), tse3.compose(Rat, tat, Rbt, tbt)):
        _close(a, b)
    for a, b in zip(jse3.inverse(Ra, ta), tse3.inverse(Rat, tat)):
        _close(a, b)
    q = g.normal(size=(32, 4)).astype(np.float32)
    v = g.normal(size=(32, 3)).astype(np.float32)
    _close(jse3.quat_multiply(jnp.asarray(q), jnp.asarray(q[::-1].copy())),
           tse3.quat_multiply(torch.tensor(q), torch.tensor(q[::-1].copy())))
    qn = np.asarray(jse3.quat_normalize(jnp.asarray(q)))
    _close(jse3.quat_rotate(jnp.asarray(qn), jnp.asarray(v)),
           tse3.quat_rotate(torch.tensor(qn), torch.tensor(v)))
    _close(jse3.quat_conjugate(jnp.asarray(q)), tse3.quat_conjugate(torch.tensor(q)))
    _close(jse3.matrix_to_quat(Ra), tse3.matrix_to_quat(Rat))
    _close(jse3.pose_identity((2,)), tse3.pose_identity((2,), device="cpu"))


def test_linalg_small_solves():
    g = np.random.default_rng(4)
    A3 = g.normal(size=(64, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    _close(jlinalg.inv3x3(jnp.asarray(A3)), tlinalg.inv3x3(torch.tensor(A3)), 1e-4)
    M = g.normal(size=(64, 6, 6)).astype(np.float32)
    A6 = (M @ M.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)).astype(np.float32)
    b6 = g.normal(size=(64, 6)).astype(np.float32)
    xj = jlinalg.chol_solve_small(jnp.asarray(A6), jnp.asarray(b6))
    xt = tlinalg.chol_solve_small(torch.tensor(A6), torch.tensor(b6))
    _close(xj, xt)
