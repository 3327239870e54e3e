"""Mean ms of device time a committed step from its start to the patches
cut: the image's conversion, the pyramid, FAST on every level, the angles,
the blur and the patches (the ``Tracer`` span ``device/step/detect``, from
the step's stage clock)."""


def read(run):
    s = run["spans"].get("device/step/detect")
    return s["total_s"] / s["count"] * 1e3 if s and s["count"] else None
