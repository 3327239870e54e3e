"""Mean ms of device time a committed step in its searches: the motion
model's projection, its narrow and wide searches, the rotation check and
scatters, then the local map's projection, search and scatters (the
``Tracer`` span ``device/step/search``, from the step's stage clock)."""


def read(run):
    s = run["spans"].get("device/step/search")
    return s["total_s"] / s["count"] * 1e3 if s and s["count"] else None
