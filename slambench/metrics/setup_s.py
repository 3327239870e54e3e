"""Seconds from the process's start to the window's: imports, the kernels'
builds, rendering the stream, building the System and the warm-up frames."""


def read(run):
    return run["setup_s"]
