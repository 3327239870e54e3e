"""Structured tracing/profiling — the aux subsystem the reference lacks.

Copy of ``asdslam_tpu/utils/tracing.py``.  The reference's only
instrumentation is commented-out clock_t spans
(src/vslam/src/LocalMapping.cc:93-95, ORBextractor.cc:174-178).  Here every
pipeline stage can be wrapped in a `Tracer.span`, accumulating wall-time
statistics with negligible overhead, and `trace_to` wraps a block in a
`torch.profiler` trace (a Chrome trace file).

Spans read the host's clock and do not synchronise the device: a span that
ends before the device's queued work is done shows only the time to queue
it.  The spans of the keyframe path each end in a fetch of their results.

Usage:
    tracer = Tracer()
    with tracer.span("track"):
        ...
    print(tracer.report())

    with trace_to("trace.json"):          # CPU + CUDA activity
        run_frames()
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List


class Span:
    __slots__ = ("count", "total", "t_min", "t_max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.t_min = float("inf")
        self.t_max = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.t_min = min(self.t_min, dt)
        self.t_max = max(self.t_max, dt)


class Tracer:
    """Hierarchical wall-clock span accumulator."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: Dict[str, Span] = {}
        # span nesting is per-thread (the asynchronous mapping worker traces its
        # own stack); the accumulator dict is shared under a lock
        self._tls = threading.local()
        self._lock = threading.Lock()

    @property
    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        stack = self._stack
        full = "/".join(stack + [name])
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            with self._lock:
                self.spans.setdefault(full, Span()).add(dt)

    def report(self) -> str:
        if not self.spans:
            return "(no spans recorded)"
        width = max(len(k) for k in self.spans)
        lines = ["%-*s  %7s  %9s  %9s  %9s  %9s" % (
            width, "span", "count", "total_s", "mean_ms", "min_ms", "max_ms")]
        for k in sorted(self.spans, key=lambda k: -self.spans[k].total):
            s = self.spans[k]
            lines.append("%-*s  %7d  %9.3f  %9.2f  %9.2f  %9.2f" % (
                width, k, s.count, s.total, s.total / s.count * 1e3,
                s.t_min * 1e3, s.t_max * 1e3))
        return "\n".join(lines)

    def as_dict(self):
        return {k: {"count": s.count, "total_s": s.total,
                    "mean_ms": s.total / s.count * 1e3}
                for k, s in self.spans.items()}

    def reset(self):
        self.spans.clear()


@contextlib.contextmanager
def trace_to(path: str):
    """torch.profiler trace (CPU and, where there is one, CUDA activity)
    around a block, written to ``path`` as a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
