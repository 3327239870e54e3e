"""Mean ms of the fused tracking step's device time a committed step, from
the step's own stage clock (the ``Tracer`` span ``device/step``: its last
stamp minus its first, both written on the card inside the replayed
graph)."""


def read(run):
    s = run["spans"].get("device/step")
    return s["total_s"] / s["count"] * 1e3 if s and s["count"] else None
