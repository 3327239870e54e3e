"""Parity of the port's iterative eigen-solvers (estimators/linalg.py) with
the JAX package's, on the same numpy inputs.  Tolerance 1e-5 on values;
vectors are compared up to the sign the algorithm leaves free."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asdslam_tpu.estimators import linalg as jl
from asdslam_torch.estimators import linalg as tl

TOL = 1e-5


def _same_up_to_sign(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    np.testing.assert_allclose(a * s, b, atol=tol)


# The minimal 8x9 system (the 8-point solve) has an exact null direction, so
# A^T A + eps tr I has condition ~1e7 in f32: the two LU routines' roundings
# then show as ~1.1e-4 in the vector (measured), though both vectors annihilate
# A equally well.  Its bar is 5e-4; the over-determined systems hold 1e-5.
@pytest.mark.parametrize("shape,tol", [((16, 8, 9), 5e-4), ((5, 12, 12), TOL),
                                       ((3, 40, 9), TOL)])
def test_null_vector(shape, tol):
    g = np.random.default_rng(shape[1])
    n = shape[-1]
    v = g.standard_normal((shape[0], n)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    B = g.standard_normal(shape).astype(np.float32)
    # rows made orthogonal to v, plus a little noise: a clear smallest direction
    A = B - np.einsum("sij,sj->si", B, v)[..., None] * v[:, None, :]
    A += 1e-3 * g.standard_normal(shape).astype(np.float32)
    j = np.asarray(jl.null_vector(jnp.asarray(A)))
    t = tl.null_vector(torch.tensor(A)).numpy()
    np.testing.assert_allclose(j, t, atol=tol)  # same start vector, same sign
    assert np.abs(np.sum(t * v, axis=-1)).min() > 0.99
    # and each is as good a null vector as the other
    rj, rt = np.linalg.norm(A @ j[..., None], axis=(1, 2)), np.linalg.norm(A @ t[..., None], axis=(1, 2))
    np.testing.assert_allclose(rj, rt, atol=1e-4)


def test_null_vector_singular():
    """An all-zero system (relocalization's PnP refit with no inlier rows)
    gives NaN for its batch element, as the reference's LU does, and
    leaves the other elements as they are; it does not raise."""
    A = np.zeros((3, 8, 9), np.float32)
    A[1] = np.random.default_rng(0).standard_normal((8, 9))
    j = np.asarray(jl.null_vector(jnp.asarray(A)))
    t = tl.null_vector(torch.tensor(A)).numpy()
    assert np.isnan(j[[0, 2]]).all() and np.isnan(t[[0, 2]]).all()
    np.testing.assert_allclose(t[1], j[1], atol=TOL)
    np.testing.assert_array_equal(t[1], tl.null_vector(torch.tensor(A[1:2])).numpy()[0])


def test_top_vector():
    g = np.random.default_rng(1)
    B = g.standard_normal((12, 6, 4)).astype(np.float32)
    M = np.einsum("bki,bkj->bij", B, B)
    j = np.asarray(jl.top_vector(jnp.asarray(M)))
    t = tl.top_vector(torch.tensor(M)).numpy()
    np.testing.assert_allclose(j, t, atol=TOL)
    w, V = np.linalg.eigh(M.astype(np.float64))
    assert np.abs(np.sum(t * V[..., -1], axis=-1)).min() > 0.999


@pytest.mark.parametrize("n", [3, 4])
def test_jacobi_eigh(n):
    g = np.random.default_rng(n)
    B = g.standard_normal((20, n, n)).astype(np.float32)
    S = B + np.swapaxes(B, -1, -2)
    wj, Vj = jl.jacobi_eigh(jnp.asarray(S))
    wt, Vt = tl.jacobi_eigh(torch.tensor(S))
    np.testing.assert_allclose(np.asarray(wj), wt.numpy(), atol=TOL)
    _same_up_to_sign(np.swapaxes(np.asarray(Vj), -1, -2),
                     np.swapaxes(Vt.numpy(), -1, -2), TOL)
    w_ref = np.linalg.eigvalsh(S.astype(np.float64))[:, ::-1]
    np.testing.assert_allclose(wt.numpy(), w_ref, atol=1e-4)


def test_svd3():
    g = np.random.default_rng(2)
    A = g.standard_normal((32, 3, 3)).astype(np.float32)
    Uj, sj, Vtj = jl.svd3(jnp.asarray(A))
    Ut, st, Vtt = tl.svd3(torch.tensor(A))
    np.testing.assert_allclose(np.asarray(sj), st.numpy(), atol=TOL)
    # U's columns and Vt's rows share one free sign per singular direction
    sgn = np.sign(np.sum(np.asarray(Vtj) * Vtt.numpy(), axis=-1))  # [B, 3]
    np.testing.assert_allclose(np.asarray(Vtj) * sgn[..., None], Vtt.numpy(), atol=TOL)
    np.testing.assert_allclose(np.asarray(Uj) * sgn[:, None, :], Ut.numpy(), atol=TOL)
    rec = torch.einsum("nij,nj,njk->nik", Ut, st, Vtt).numpy()
    np.testing.assert_allclose(rec, A, atol=2e-2)
