"""K1's share of its roofline over the profiled slice, in %: the least time
its launches' bytes need at the card's bandwidth (each launch's inputs read
once and outputs written once, ``roofline.matcher_bytes``), over the
profiler's device time of K1's three kernels.  The operations' bound needs
the gated-in pair count, which no counter gives inside a graph, so the
bytes bound stands alone."""

from roofline import matcher_bytes

K1_KERNELS = ("order_kernel", "gather_kernel", "search_kernel")


def read(run):
    prof = run["profile"]
    if prof is None or run["peaks"] is None or not prof["k1_launches"]:
        return None
    dev_s = sum(t1 - t0 for name, t0, t1 in prof["kernels"]
                if any(k in name for k in K1_KERNELS)) * 1e-6
    if dev_s <= 0:
        return None
    least = sum(matcher_bytes(n, m, d) for n, m, d in prof["k1_launches"]) / run["peaks"]["bytes"]
    return 100.0 * least / dev_s
