"""Mean ms of the tracker's one fetch of the fused step's result (the
``Tracer`` span ``.../fused_track/kernel``) over the window."""


def read(run):
    n = t = 0
    for name, s in run["spans"].items():
        if name.endswith("fused_track/kernel"):
            n, t = n + s["count"], t + s["total_s"]
    return t / n * 1e3 if n else None
