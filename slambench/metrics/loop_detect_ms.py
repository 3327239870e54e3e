"""Mean ms of the loop closer's work a keyframe (its ``loop_closing`` span:
the bag of words and the detection) in the window."""


def read(run):
    s = run["spans"].get("loop_closing")
    return s["total_s"] / s["count"] * 1e3 if s and s["count"] else None
