"""CUDA-graph capture of fixed-shape device functions: the port's
counterpart of ``jax.jit``.

The reference compiles each hot path into one XLA program (``jax.jit`` on
the fused step, track_step.py:108; the extractor, extractor.py:74 and :126;
pose-only and local BA, ba.py:101 and :223; the essential graph,
pose_graph.py:46; global BA, global_ba.py:29).  The port runs the same
functions as PyTorch launches, each a few microseconds of host time, so a
step of thousands of small kernels is bound by the host.  ``captured(fn,
name)`` records such a function once in a ``torch.cuda.CUDAGraph`` and
replays it:

- On a CUDA device the callable keys its graphs on the input tree: its
  structure, each tensor's shape, dtype and device, every other leaf's value
  (``None`` included), and the caller's stream.  The first call with a new
  key runs ``fn`` eagerly on the capture's side stream (the warm-up: library
  handles, the kernels' one-off attributes) and returns its result; the
  second captures ``fn`` into static input and output buffers; that call and
  every later one copy the inputs into the static buffers on the caller's
  stream, replay, and return clones of the static outputs, so a result
  outlives the next replay.  Each graph owns a private memory pool; a
  callable keeps at most ``MAX_GRAPHS`` keys, dropping the oldest.
- On CPU tensors the callable is ``fn``: the CPU path, which the tests hold
  against the reference.  ``.eager`` is ``fn`` itself, for comparisons.
  ``graph_path(*tensors)`` tells a caller which path a call takes, so that
  it can pad its inputs to fixed shapes where a graph will replay them.
- A call made while the current stream is capturing runs ``fn``, which thus
  becomes part of the outer graph (the extractor inside the fused step); so
  does a call inside a ``torch.func`` transform (its tensors are the
  transform's wrappers: the extractor inside the vmapped multi-sequence
  step).
- There is no route around the graph on the card: a failed capture raises.
  Nothing captured may read back to the host (a ``.item()``, a device to
  host copy, a host-to-device copy from pageable memory): the capture runs
  in ``"thread_local"`` mode, which refuses that in the capturing thread
  and lets other threads synchronise meanwhile (the tracker fetches while
  the mapping worker captures local BA).
- A host-side effect of captured code, such as a kernel's launch counter,
  goes through ``host_effect(f)``: ``f()`` runs at once outside a capture,
  and inside one is recorded and run at each replay instead.
- The captured path records no autograd history, but for a training step
  (``captured(fn, name, grad=True)``): there the graph holds the forward,
  the backward and the in-place update of the parameters, PyTorch's
  whole-network capture.  Such an ``fn`` takes its gradients with
  ``torch.autograd.grad``, so that they are allocated in the graph's pool
  and no ``.grad`` outlives the step, and updates the parameters and
  buffers it closes over (or takes as constant leaves, such as a module) in
  place: they are not inputs, the graph reads and writes them where they
  lie.  A module among the constant leaves keys by its id, and its keys'
  graphs are dropped at the first call after it is collected (a trained
  model's graphs hold gigabytes).
- The key also holds cuDNN's ``deterministic`` and ``benchmark`` flags and
  ``torch.are_deterministic_algorithms_enabled()``, which choose the
  algorithms a graph records.
- ``last_call()`` says what the calling thread's last call of a captured
  callable did ("eager", "warm-up", "capture" or "replay"), for timings.

Two threads must not share a stream while they call captured functions (the
tracker and the mapping worker each have their own).  Warm-ups and captures
run one at a time in the process, on one high-priority side stream per
device: PyTorch hands out its pooled streams round-robin, and a capture must
not run on a stream that another thread is using, such as a tracker's mapping
stream, which comes from the default-priority pool.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref

import torch

MAX_GRAPHS = 16   # keys kept per captured callable

_tls = threading.local()        # .effects: the host effects of this thread's capture
_capture_lock = threading.RLock()  # one warm-up or capture at a time
_side_streams = {}              # device index -> the side stream of warm-ups and captures


def last_call():
    """What this thread's last call of a captured callable did: "eager" (CPU
    inputs, or inside a capture), "warm-up", "capture" (with its first
    replay) or "replay"; None before any."""
    return getattr(_tls, "last", None)


def host_effect(f):
    """Run ``f()`` now, or, while this thread captures a graph, at each of
    that graph's replays instead (a capture executes nothing)."""
    effects = getattr(_tls, "effects", None)
    if effects is None:
        f()
    else:
        effects.append(f)


# --------------------------------------------------------------------------- #
# Input and output trees
# --------------------------------------------------------------------------- #
def _flatten(x, leaves, modules=None):
    """Append the tensor leaves of ``x`` (tuples, named tuples, lists and
    dicts of tensors and constants) to ``leaves``, and its modules to
    ``modules``; return its signature.  A module stands in it by its id,
    so that a key does not keep the module alive."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, torch.nn.Module):
        if modules is not None:
            modules.append(x)
        return (type(x), id(x))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves, modules) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(v, leaves, modules)) for k, v in x.items()))
    return (type(x), x)


def _rebuild(x, tensors):
    """``x`` with its tensor leaves replaced, in order, by ``tensors``."""
    if isinstance(x, torch.Tensor):
        return next(tensors)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_rebuild(v, tensors) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, tensors) for v in x)
    if isinstance(x, dict):
        return {k: _rebuild(v, tensors) for k, v in x.items()}
    return x


# --------------------------------------------------------------------------- #
# The card's side: a test replaces these with fakes that run on the CPU
# --------------------------------------------------------------------------- #
def _graph_device(leaves):
    """The CUDA device of the tensor leaves, or None when they all lie on
    the CPU (or there are none)."""
    cuda = [t.device for t in leaves if t.device.type == "cuda"]
    if not cuda:
        return None
    if len(cuda) != len(leaves) or len(set(cuda)) != 1:
        devices = sorted({str(t.device) for t in leaves})
        raise ValueError(f"captured: inputs on {devices}; a graph takes tensors of one CUDA "
                         "device")
    return cuda[0]


def graph_path(*tensors) -> bool:
    """Whether a captured call with these tensor inputs takes the graph path
    (they lie on one CUDA device), so that its caller can give it the fixed
    shapes that let one graph serve every call."""
    return _graph_device(list(tensors)) is not None


def _capturing():
    return torch.cuda.is_current_stream_capturing()


def _transformed(leaves):
    """Whether a leaf is a ``torch.func`` wrapper (a vmapped call)."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return any(isinstance(t, torch.Tensor) and wrapped(t) for t in leaves)


def _stream_key(device):
    return torch.cuda.current_stream(device).cuda_stream


def _algorithm_flags():
    """The switches that choose the library algorithms a capture records."""
    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled())


def _side_stream(device):
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _side_streams.get(index)
    if stream is None:
        # the high-priority pool: no stream of the port's own comes from it
        stream = _side_streams[index] = torch.cuda.Stream(device, priority=-1)
    return stream


def _warm(fn, args, kwargs, device):
    """``fn`` run eagerly on the side stream, ordered after the caller's
    stream's queued work and before its later work."""
    caller, side = torch.cuda.current_stream(device), _side_stream(device)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        out = fn(*args, **kwargs)
    caller.wait_stream(side)
    leaves = []
    _flatten(out, leaves)
    for t in leaves:
        t.record_stream(caller)  # made on the side stream, used on the caller's
    return out


def _capture(fn, args, kwargs, device):
    """(graph, outputs): ``fn(*args, **kwargs)`` captured on the side stream
    into a graph with a private memory pool."""
    caller, side = torch.cuda.current_stream(device), _side_stream(device)
    side.wait_stream(caller)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn(*args, **kwargs)
        finally:
            graph.capture_end()
    caller.wait_stream(side)
    return graph, out


def _replay(graph):
    graph.replay()  # on the caller's current stream


def _reserved(device):
    return torch.cuda.memory_reserved(device) if device.type == "cuda" else 0


# --------------------------------------------------------------------------- #
# The callable
# --------------------------------------------------------------------------- #
class _Entry:
    __slots__ = ("graph", "inputs", "outputs", "out_leaves", "effects", "replays",
                 "pool_bytes", "capture_ms")

    def __init__(self):
        self.graph = None
        self.replays = 0


class Captured:
    """``fn`` captured per input key (module docstring)."""

    def __init__(self, fn, name: str, grad: bool = False):
        self.eager = fn
        self.name = name
        self.grad = grad
        self.__doc__, self.__wrapped__ = fn.__doc__, fn  # help() and inspect see fn
        self._entries = collections.OrderedDict()
        self._dead = []                # keys of collected modules
        self._lock = threading.Lock()  # guards _entries

    def __call__(self, *args, **kwargs):
        leaves, modules = [], []
        sig = _flatten((args, kwargs), leaves, modules)
        device = _graph_device(leaves)
        if (device is None or getattr(_tls, "effects", None) is not None or _capturing()
                or _transformed(leaves)):
            out = self.eager(*args, **kwargs)
            _tls.last = "eager"
            return out
        key = (sig, _stream_key(device), _algorithm_flags())
        with self._lock:
            self._purge()
            entry = self._entries.get(key)
            if entry is None:
                if len(self._entries) >= MAX_GRAPHS:
                    # a dropped graph's pool is freed only once no replay
                    # can use it; its static inputs were used on this stream
                    self._entries.popitem(last=False)
                self._entries[key] = _Entry()
                for m in modules:  # its graphs go with it
                    weakref.finalize(m, self._forget, key)
            else:
                self._entries.move_to_end(key)
        with torch.enable_grad() if self.grad else torch.no_grad():
            if entry is None:
                with _capture_lock:
                    out = _warm(self.eager, args, kwargs, device)
                _tls.last = "warm-up"
                return out
            kind = "replay"
            if entry.graph is None:
                kind = "capture"
                self._capture(entry, args, kwargs, leaves, device)
            for dst, src in zip(entry.inputs, leaves):
                dst.copy_(src)
            _replay(entry.graph)
            for f in entry.effects:
                f()
            entry.replays += 1
            _tls.last = kind
            return _rebuild(entry.outputs, (t.clone() for t in entry.out_leaves))

    def _capture(self, entry, args, kwargs, leaves, device):
        static = [t.detach().clone(memory_format=torch.contiguous_format) for t in leaves]
        s_args, s_kwargs = _rebuild((args, kwargs), iter(static))
        with _capture_lock:
            before, t0 = _reserved(device), time.perf_counter()
            _tls.effects = effects = []
            try:
                graph, out = _capture(self.eager, s_args, s_kwargs, device)
            finally:
                _tls.effects = None
            entry.capture_ms = (time.perf_counter() - t0) * 1e3
            entry.pool_bytes = _reserved(device) - before
        entry.out_leaves = []
        _flatten(out, entry.out_leaves)
        entry.inputs, entry.outputs, entry.effects, entry.graph = static, out, effects, graph

    def _forget(self, key):
        # a finalizer may run inside any allocation, the locked regions
        # here included: the key is dropped at the next call
        self._dead.append(key)

    def _purge(self):
        while self._dead:
            self._entries.pop(self._dead.pop(), None)

    def stats(self):
        """One dict per captured key: replays, the reserved memory that the
        capture added (its pool, mostly), the capture's host ms."""
        with self._lock:
            self._purge()
            entries = list(self._entries.values())
        return [dict(replays=e.replays, pool_bytes=e.pool_bytes, capture_ms=e.capture_ms)
                for e in entries if e.graph is not None]


def captured(fn, name: str, grad: bool = False) -> Captured:
    """``fn`` captured in CUDA graphs on the card, ``fn`` itself on the CPU
    (module docstring); ``grad``: a training step, captured with autograd
    on."""
    return Captured(fn, name, grad)
