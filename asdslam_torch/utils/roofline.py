"""Peak rates of the card the port is measured on, the roofline
accounting that holds a measured time against them, and the timer of the
measurement scripts.

One definition of the peaks, read by ``mfu_bench_torch.py`` and by
``chip_smoke.py``'s kernel bounds.  They are those of NVIDIA's data sheet
for the H100 SXM part (dense, no sparsity), keyed by the name
``torch.cuda.get_device_name`` gives that card: 989 TFLOP/s in bf16 on the
tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s of HBM3.  They
assume the full 700 W; the caller prints the card's power limit beside
every share.  Another card has no entry and raises, rather than being held
to a guessed peak.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

CARD_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12},
}
H100 = CARD_PEAKS["NVIDIA H100 80GB HBM3"]
# a share above this means a count or a timing is wrong (a share of a true
# peak cannot pass 1; the margin is for clock boost and timer granularity)
MAX_SHARE = 1.05


def peaks_for(card_name: str) -> Dict[str, float]:
    """The peak rates of the card named ``card_name``; raises for a card
    without an entry."""
    if card_name not in CARD_PEAKS:
        raise ValueError(f"no peak rates for the card {card_name!r} (known: "
                         f"{sorted(CARD_PEAKS)}); add its data-sheet peaks to CARD_PEAKS")
    return CARD_PEAKS[card_name]


def matcher_bytes(n: int, m: int, d: int) -> int:
    """The masked nearest-neighbour search's bytes, each input read once
    and each output written once: the float32 descriptors, and per row its
    validity (1 byte), position (2 float32), pyramid level (int32), and per
    query row its squared radius (float32); out, per query row, the index
    and the best and second distances (4 bytes each).  The [n, m] distance
    matrix is not counted: the function does not need it, and the kernel
    never writes it."""
    return (n + m) * (d * 4 + 1 + 8 + 4) + n * 4 + n * 12


def matcher_flops(pairs_in: int, d: int) -> int:
    """The masked nearest-neighbour search's FLOPs on its data: the dot
    product of every pair that passes the gates (window, validity, level
    band), 2·d each.  A pair the gates reject needs no dot, so this is what
    the function needs, not 2·n·m·d."""
    return 2 * d * int(pairs_in)


def roofline_row(name: str, ms: float, flops: float, bytes_: float,
                 peaks: Optional[Dict[str, float]], peak: str) -> dict:
    """One row of the roofline table: the work (GFLOP, MB), the time, and,
    against ``peaks[peak]`` (the compute peak the work runs at: "bf16" or
    "f32") and ``peaks["bytes"]``, the MFU, the bandwidth share, which of
    the two bounds the least time, that least time and the share of it
    reached (sol_frac).  ``peaks`` None (a run off the card) leaves every
    share null.  A share above MAX_SHARE raises."""
    row = {"name": name, "ms": ms, "gflops": flops / 1e9, "mbytes": bytes_ / 1e6,
           "peak": peak, "mfu": None, "bw_util": None, "bound": None, "sol_ms": None,
           "sol_frac": None}
    if peaks is None:
        return row
    t = ms / 1e3
    t_ops, t_bytes = flops / peaks[peak], bytes_ / peaks["bytes"]
    t_sol = max(t_ops, t_bytes)
    row.update(mfu=t_ops / t, bw_util=t_bytes / t,
               bound="compute" if t_ops >= t_bytes else "bandwidth",
               sol_ms=t_sol * 1e3, sol_frac=t_sol / t)
    over = {k: row[k] for k in ("mfu", "bw_util", "sol_frac") if row[k] > MAX_SHARE}
    if over:
        raise AssertionError(f"{name}: shares {over} above {MAX_SHARE} of the {peak} peak "
                             f"({ms} ms for {flops:.4g} FLOP, {bytes_:.4g} B): a count or a "
                             f"timing is wrong")
    return row


def time_ms(fn, device, calls: int = 10, windows: int = 5) -> float:
    """Median ms per call of ``fn`` over ``windows`` windows of ``calls``
    chained calls after one warm-up call, one synchronisation a window:
    CUDA events on the card, the host clock off it."""
    import torch

    cuda = device.type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    samples = []
    for _ in range(windows):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            samples.append((time.perf_counter() - t0) * 1e3 / calls)
    return float(np.median(samples))
