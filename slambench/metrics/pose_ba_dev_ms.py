"""Mean ms of device time a committed step in its two pose-only BAs (the
``Tracer`` span ``device/step/pose_ba``, from the step's stage clock)."""


def read(run):
    s = run["spans"].get("device/step/pose_ba")
    return s["total_s"] / s["count"] * 1e3 if s and s["count"] else None
