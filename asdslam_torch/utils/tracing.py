"""Structured tracing/profiling — the aux subsystem the reference lacks.

Port of ``asdslam_tpu/utils/tracing.py``.  The reference's only
instrumentation is commented-out clock_t spans
(src/vslam/src/LocalMapping.cc:93-95, ORBextractor.cc:174-178).  Here every
pipeline stage can be wrapped in a `Tracer.span`, accumulating wall-time
statistics with negligible overhead.

Spans read the host's clock and do not synchronise the device: a span that
ends before the device's queued work is done shows only the time to queue
it.  The spans of the keyframe path each end in a fetch of their results.
``Tracer.add`` records a duration measured on another clock.  While a span
is open, its tracer is the calling thread's active tracer (``active``), on
which code that does not hold the tracer, such as a graph build
(``utils/graphs.py``), records its own spans (``active_span``).

The stage clock times stages inside one device program, such as a step
replayed from a CUDA graph, where the host sees a single call.
``stage_clock(names, device)`` opens it in the calling thread around the
program's eager function; each ``stage(name)`` inside writes the time into
the next slot of an int64 buffer: on a CUDA device a one-thread kernel
(``csrc/stamp.cu``) writes the card's ``%globaltimer`` once the work queued
before it has run, and inside a capture that launch is a node of the graph,
so each replay stamps afresh; on the CPU, whose execution is synchronous,
``time.perf_counter_ns()``.  Differences of stamps are the stages' device
times.  With no clock open, or under a ``torch.func`` transform, ``stage``
does nothing and launches nothing.

Usage:
    tracer = Tracer()
    with tracer.span("track"):
        ...
    print(tracer.report())

    with stage_clock(("start", "mid", "end"), device) as clock:
        stage("start"); ...; stage("mid"); ...; stage("end")
    clock.stamps        # int64 [3], ns
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time
from typing import Dict, List, Sequence

import torch

_tls = threading.local()  # .tracer: the active tracer; .clock: the open stage clock


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
        outer, _tls.tracer = active(), self
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            _tls.tracer = outer
            stack.pop()
            self.add(full, dt)

    def add(self, name: str, seconds: float):
        """Record a duration measured elsewhere (another clock) as one call
        of the span ``name``, as given: not nested under the open spans."""
        if not self.enabled:
            return
        with self._lock:
            self.spans.setdefault(name, Span()).add(seconds)

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


def active():
    """The tracer whose span is innermost open in the calling thread, or
    None."""
    return getattr(_tls, "tracer", None)


def active_span(name: str):
    """A span ``name`` of the active tracer, nested under its open spans;
    nothing without one."""
    tracer = active()
    return tracer.span(name) if tracer is not None else contextlib.nullcontext()


# --------------------------------------------------------------------------- #
# The stage clock
# --------------------------------------------------------------------------- #
class StageClock:
    """An open clock: ``names`` the stages in order, ``stamps`` their int64
    [len(names)] times in ns, ``done`` how many are stamped."""

    __slots__ = ("names", "stamps", "done")

    def __init__(self, names: Sequence[str], device):
        self.names = tuple(names)
        # no fill: every slot is stamped before the clock closes
        self.stamps = torch.empty(len(self.names), dtype=torch.int64, device=device)
        self.done = 0


@contextlib.contextmanager
def stage_clock(names: Sequence[str], device):
    """Open a stage clock in the calling thread for the stages ``names``
    (module docstring) and yield it.  Its buffer is made here, so inside a
    capture it lies in the graph's pool.  Every stage must be stamped by
    the time the block ends."""
    clock = StageClock(names, device)
    outer, _tls.clock = clock_open(), clock
    try:
        yield clock
    finally:
        _tls.clock = outer
    if clock.done != len(clock.names):
        raise RuntimeError(f"stage clock closed after {clock.done} of its stages "
                           f"{clock.names}")


def clock_open():
    """The stage clock open in the calling thread, or None."""
    return getattr(_tls, "clock", None)


def stage(name: str):
    """Stamp the stage ``name``, the open clock's next, in its slot.  Does
    nothing with no clock open or under a ``torch.func`` transform."""
    clock = clock_open()
    if clock is None or torch._C._functorch.peek_interpreter_stack() is not None:
        return
    if clock.done == len(clock.names) or clock.names[clock.done] != name:
        raise RuntimeError(f"stage {name!r} out of order: {clock.names}, "
                           f"{clock.done} stamped")
    stamp(clock.stamps, clock.done)
    clock.done += 1


@functools.lru_cache(maxsize=None)
def _stamp_lib():
    from asdslam_torch import kernels

    lib = kernels.load("stamp")
    lib.stamp_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.stamp_launch.restype = ctypes.c_int
    return lib


def stamp(buf: torch.Tensor, i: int):
    """Write the time in ns into ``buf[i]`` (int64): the card's
    ``%globaltimer`` by a kernel on the current stream for a CUDA buffer,
    ``time.perf_counter_ns()`` for a CPU one."""
    if (buf.dtype != torch.int64 or buf.ndim != 1 or not buf.is_contiguous()
            or not 0 <= i < buf.shape[0]):
        raise ValueError(f"stamp: slot {i} of a {buf.dtype} buffer of shape "
                         f"{tuple(buf.shape)}")
    if buf.device.type != "cuda":
        buf[i] = time.perf_counter_ns()
        return
    index = buf.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    with torch.cuda.device(index):
        rc = _stamp_lib().stamp_launch(buf.data_ptr(), i, stream)
    if rc != 0:
        raise RuntimeError(f"stamp kernel launch failed: cudaError_t {rc}")
