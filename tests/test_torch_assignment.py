"""Parity of the port's assignment engines (asdslam_torch.ops.assignment)
with the JAX package's: twins of tests/test_assignment.py, and both policies
on random masked score matrices full of ties against the JAX functions.
Every output is exact: the same argmax tie order (first occurrence, flat
for the greedy engine) over the same float32 scores."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from asdslam_tpu.ops import assignment as jassign
from asdslam_torch.ops import assignment as tassign


def _brute_greedy(score, valid, min_score):
    """Reference implementation: sort all admissible pairs, commit best-first."""
    N, M = score.shape
    pairs = [(score[i, j], i, j) for i in range(N) for j in range(M)
             if valid[i, j] and score[i, j] >= min_score]
    pairs.sort(key=lambda t: -t[0])
    used_r, used_c = set(), set()
    out = np.full(N, -1, np.int32)
    for s, i, j in pairs:
        if i not in used_r and j not in used_c:
            out[i] = j
            used_r.add(i)
            used_c.add(j)
    return out


# twins of tests/test_assignment.py
def test_greedy_matches_brute_force():
    rng = np.random.default_rng(0)
    for trial in range(5):
        N, M = 13, 9
        score = rng.normal(size=(N, M)).astype(np.float32)
        valid = rng.random((N, M)) > 0.3
        col, ok = tassign.greedy_assignment(torch.tensor(score), torch.tensor(valid),
                                            min_score=-1.0)
        ref = _brute_greedy(score, valid, -1.0)
        assert col.dtype == torch.int32
        np.testing.assert_array_equal(col.numpy(), ref)
        assert np.array_equal(ok.numpy(), ref >= 0)


def test_greedy_exclusivity():
    score = torch.tensor([[5.0, 1.0], [4.0, 3.0]])
    col, ok = tassign.greedy_assignment(score, torch.ones((2, 2), dtype=torch.bool))
    assert col.tolist() == [0, 1] and ok.all()


def test_non_exclusive_shares_columns():
    score = torch.tensor([[5.0, 1.0], [4.0, 3.0]])
    valid = torch.ones((2, 2), dtype=torch.bool)
    col, s, ok = tassign.non_exclusive_assignment(score, valid)
    assert col.tolist() == [0, 0] and ok.all()
    col, s, ok = tassign.non_exclusive_assignment(score, valid, min_score=4.5)
    assert ok.tolist() == [True, False]


def test_greedy_all_invalid():
    col, ok = tassign.greedy_assignment(torch.zeros((3, 3)), torch.zeros((3, 3), dtype=torch.bool))
    assert (col == -1).all() and not ok.any()


# --------------------------------------------------------------------------- #
# Against the JAX functions
# --------------------------------------------------------------------------- #
def _masked_problem(seed, n, m, levels=5, density=0.6):
    """Scores drawn from a few levels (ties everywhere, within rows, columns
    and across the matrix) and a random admissibility mask."""
    g = np.random.default_rng(seed)
    score = g.integers(0, levels, (n, m)).astype(np.float32) / levels
    valid = g.random((n, m)) < density
    return score, valid


@pytest.mark.parametrize("shape,min_score,max_assignments", [
    ((40, 30), -np.inf, 0), ((30, 45), 0.4, 0), ((50, 50), 0.2, 7), ((1, 9), -np.inf, 0),
    ((64, 17), 0.8, 0)])
def test_greedy_against_jax(shape, min_score, max_assignments):
    score, valid = _masked_problem(sum(shape), *shape)
    jcol, jok = jassign.greedy_assignment(jnp.asarray(score), jnp.asarray(valid),
                                          min_score=float(min_score),
                                          max_assignments=max_assignments)
    tcol, tok = tassign.greedy_assignment(torch.tensor(score), torch.tensor(valid),
                                          min_score=float(min_score),
                                          max_assignments=max_assignments)
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    if max_assignments:
        assert int(tok.sum()) <= max_assignments


@pytest.mark.parametrize("shape,min_score", [((40, 30), -np.inf), ((30, 45), 0.6), ((8, 1), 0.0)])
def test_non_exclusive_against_jax(shape, min_score):
    score, valid = _masked_problem(7 * sum(shape), *shape, density=0.3)
    valid[0] = False  # a row with nothing admissible
    j = jassign.non_exclusive_assignment(jnp.asarray(score), jnp.asarray(valid),
                                         min_score=float(min_score))
    t = tassign.non_exclusive_assignment(torch.tensor(score), torch.tensor(valid),
                                         min_score=float(min_score))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert t[0].dtype == torch.int32 and int(t[0][0]) == -1 and not bool(t[2][0])


@pytest.mark.gpu
def test_assignment_on_cuda_equals_cpu():
    """Both policies on the card against the port's CPU result, exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    score, valid = _masked_problem(3, 300, 200)
    s, v = torch.tensor(score), torch.tensor(valid)
    for fn in (tassign.greedy_assignment, tassign.non_exclusive_assignment):
        cpu = fn(s, v, 0.2)
        gpu = fn(s.cuda(), v.cuda(), 0.2)
        for a, b in zip(cpu, gpu):
            assert torch.equal(a, b.cpu())
