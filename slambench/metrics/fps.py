"""Frames completed a second: the frames fed to ``track_monocular`` in the
window over the window's host-clock seconds."""


def read(run):
    return run["frames"] / run["window_s"] if run["frames"] else None
