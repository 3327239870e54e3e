"""ms a frame that the tracker waited to join the mapping worker: the
``join_mapping`` spans' total over the window, over the window's frames."""


def read(run):
    t = sum(s["total_s"] for name, s in run["spans"].items()
            if name.split("/")[-1] == "join_mapping")
    return t / run["frames"] * 1e3 if run["frames"] else None
