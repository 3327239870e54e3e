"""Matching-engine assignment policies (aslam_cv2 matcher parity).

Port of ``asdslam_tpu/ops/assignment.py``: the two generic matching engines
of the reference's vendored aslam_cv2 matcher package
(``MatchingEngineNonExclusive`` / ``MatchingEngineGreedy``) as batched
functions over a dense score matrix.  Scores follow aslam's convention:
HIGHER is better, ``valid`` gates admissible pairs; for descriptor distances
pass ``-dist``.

* ``non_exclusive_assignment``: every row takes its best admissible column;
  columns may be claimed by many rows.
* ``greedy_assignment``: globally best-first one-to-one assignment; the
  highest-scoring (row, col) pair is committed, both are retired, repeat.

The reference computes both with XLA ops (no Pallas kernel), and so does
the port with torch ops on the tensors' device; the greedy engine, which
the reference jits, is one captured program on the card.
"""

from __future__ import annotations

import torch

from asdslam_torch.utils import graphs

NEG = float("-inf")


def non_exclusive_assignment(score: torch.Tensor, valid: torch.Tensor,
                             min_score: float = NEG):
    """Row-wise best admissible column, columns reusable; ties go to the
    first column.

    Returns (col_idx [N] int32 with -1 where unassigned, col_score [N],
    assigned [N] bool)."""
    s = torch.where(valid, score, NEG)
    idx = torch.argmax(s, dim=1)
    best = torch.gather(s, 1, idx[:, None])[:, 0]
    ok = torch.isfinite(best) & (best >= min_score)
    return torch.where(ok, idx, -1).to(torch.int32), best, ok


def _greedy(score: torch.Tensor, valid: torch.Tensor, min_score: float = NEG,
            max_assignments: int = 0):
    """Globally best-first one-to-one assignment (MatchingEngineGreedy).

    score: [N, M] (higher better), valid: [N, M] admissible pairs.
    Returns (col_of_row [N] int32 with -1 for unassigned, assigned [N] bool).

    Each trip commits the flat first-occurrence argmax (``jnp.argmax``'s
    tie order) and retires its row and column.  The reference stops its
    ``while_loop`` at ``max_assignments`` trips (0: min(N, M)) or when no
    finite score is left; here every trip of that fixed count runs and is
    guarded by "anything finite left", which gives the same result without
    reading the device on each trip.  O(min(N, M) * N * M): sized for the
    engines' workloads (hundreds of candidates), not the 2000 x 2000
    feature-matching hot path, which uses ops/match.py's matchers.
    """
    N, M = score.shape
    trips = max_assignments or min(N, M)
    s = torch.where(valid, score, NEG)
    s = torch.where(s >= min_score, s, NEG)
    col_of_row = torch.full((N,), -1, dtype=torch.int32, device=score.device)
    rows = torch.arange(N, device=score.device)
    cols = torch.arange(M, device=score.device)
    for _ in range(trips):
        flat = torch.argmax(s.reshape(-1))
        live = torch.isfinite(torch.amax(s))  # the reference's loop condition
        i, j = flat // M, flat % M
        retire_row = (rows == i) & live
        retire_col = (cols == j) & live
        col_of_row = torch.where(retire_row, j.to(torch.int32), col_of_row)
        s = torch.where(retire_row[:, None] | retire_col[None, :], NEG, s)
    return col_of_row, col_of_row >= 0


# The greedy engine as one program (the reference jits its while_loop,
# asdslam_tpu/ops/assignment.py:46): its trips read nothing back, so the
# whole fixed-trip loop is one graph a shape
greedy_assignment = graphs.captured(_greedy, "greedy_assignment")
