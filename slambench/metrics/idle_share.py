"""The device's idle share of the profiled slice, in %: 100 minus the union
of the kernels' busy intervals over the slice's wall time."""


def read(run):
    prof = run["profile"]
    if prof is None or prof["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
