"""The whole step's share of the card's bf16 peak over the window, in %:
the descriptor network's conv FLOPs for every feature slot of every frame
(``roofline.asdnet_flops``), over the window's seconds times the peak.  The
searches' FLOPs need the gated-in pair count and are left out."""

from roofline import asdnet_flops


def read(run):
    if not run["frames"] or run["peaks"] is None:
        return None
    flops = asdnet_flops(run["n_features"]) * run["frames"]
    return 100.0 * flops / (run["window_s"] * run["peaks"]["bf16"])
