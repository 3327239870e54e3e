"""The yardstick's arithmetic: the card's peak rates and the work of the
kernels and of the step, counted from their shapes.

Frozen copies of ``asdslam_torch/utils/roofline.py`` (the peaks,
``matcher_bytes``) and of ``mfu_bench_torch.py::asdnet_flops``, kept with
the benchmark so that a change to the program does not move the yardstick.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM part (dense, no sparsity), keyed by
# the name torch.cuda.get_device_name gives the card; they assume 700 W
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12},
}

# (H_out, W_out, C_in, C_out, k) of ASDNet's seven convs on a 32x32 patch
ASDNET_CONVS = ((32, 32, 1, 32, 3), (32, 32, 32, 32, 3), (16, 16, 32, 64, 3),
                (16, 16, 64, 64, 3), (8, 8, 64, 128, 3), (8, 8, 128, 128, 3),
                (1, 1, 128, 128, 8))


def peaks_for(card: str) -> dict:
    """The peaks of the card named ``card``; a card without an entry raises
    rather than being held to a guessed peak."""
    if card not in CARD_PEAKS:
        raise ValueError(f"no peak rates for the card {card!r}; add its data-sheet peaks")
    return CARD_PEAKS[card]


def asdnet_flops(n_patches: int) -> int:
    """The conv tower's FLOPs, 2 H W C_in C_out k^2 a conv: 78,184,448 a
    patch."""
    return n_patches * sum(2 * h * w * ci * co * k * k for h, w, ci, co, k in ASDNET_CONVS)


def matcher_bytes(n: int, m: int, d: int) -> int:
    """The masked top-2 search's bytes, each input read once and each output
    written once: per row of either side the float32 descriptor, validity
    (1 byte), position (8) and level (4); per query row its squared radius
    (4) and, out, its index and two distances (12)."""
    return (n + m) * (d * 4 + 1 + 8 + 4) + n * 4 + n * 12
