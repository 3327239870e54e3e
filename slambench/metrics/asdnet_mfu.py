"""ASDNet's share of the card's bf16 peak inside the step, in %: the conv
tower's FLOPs for every feature slot of every committed step
(``roofline.asdnet_flops``), over the device time the step's stage clock
gives the descriptor stage (the ``Tracer`` span ``device/step/describe``)
times the peak."""

from roofline import asdnet_flops


def read(run):
    s = run["spans"].get("device/step/describe")
    if not s or not s["count"] or s["total_s"] <= 0 or run["peaks"] is None:
        return None
    flops = asdnet_flops(run["n_features"]) * s["count"]
    return 100.0 * flops / (s["total_s"] * run["peaks"]["bf16"])
