"""Mean ms of the mapping worker's pass over a keyframe (its ``mapping``
span: fuse, local BA, keyframe culling) in the window."""


def read(run):
    s = run["spans"].get("mapping")
    return s["total_s"] / s["count"] * 1e3 if s and s["count"] else None
