"""One call per sequence inside a batched (``torch.func.vmap``) function.

The multi-sequence tracking step is ``torch.func.vmap`` of the single step
(``frontend/track_step.py::make_batched_track_step``), and each sequence's
results must be the single step's bits.  Elementwise kernels give every
element the same bits wherever it lies in a batch, as do the searches, the
gathers and the integer and min / max reductions.  What a batch can change:

- a library kernel picked by shape, and with it the order of its sums:
  cuBLAS's and the CPU BLAS's matrix products, cuDNN's and the CPU's
  convolutions;
- a float reduction, whose threads, vector width and alignment PyTorch
  picks by the number of rows and the address of the data;
- on the CPU, a vectorised transcendental (sin, atan2, log ...), whose
  ragged tail takes the scalar routine, which differs in the last bit.

``sequential(fn)`` is ``fn``, except inside a ``per_sequence()`` block (the
batched step's) on vmapped tensors: there it calls ``fn`` once per sequence, in order, each on a fresh copy of that sequence's
inputs (allocated and strided as the single step's own), and stacks the
results: the batched step then runs what the single step runs for each
sequence, inside the same CUDA graph.  With ``cpu_only`` (the elementwise
transcendentals) it does so on CPU tensors only; on a card such a function
runs once over the whole batch.  It is the custom operator
``torch.ops.asdslam.sequential`` with a vmap rule; ``fn`` returns a tensor or
a (nested) tuple of tensors, never one of its inputs, takes its tensors
as top-level arguments and closes over nothing that is batched.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils import _pytree as pytree

from asdslam_torch.utils import graphs

_CALLS = {}  # key -> the call being made: fn, its argument tree, its output tree
_state = threading.local()  # .on: inside a per_sequence() block of this thread


@contextlib.contextmanager
def per_sequence():
    """The block in which a vmapped call of a ``sequential`` function runs
    once per sequence: the batched tracking step's.  Outside it (another
    ``torch.func`` transform, such as ``jacfwd``, vmaps too) the function
    runs as it is."""
    prev = getattr(_state, "on", False)
    _state.on = True
    try:
        yield
    finally:
        _state.on = prev


class _Call:
    """One call of ``fn``: its arguments, with the tensors' places, and the
    tree of its outputs once it has run."""

    __slots__ = ("fn", "args", "kwargs", "slots", "out_spec")

    def __init__(self, fn, args, kwargs):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.slots = [i for i, x in enumerate((*args, *kwargs.values()))
                      if isinstance(x, torch.Tensor)]
        self.out_spec = None

    def __call__(self, tensors):
        values = list((*self.args, *self.kwargs.values()))
        for i, t in zip(self.slots, tensors):
            values[i] = t
        n = len(self.args)
        out, self.out_spec = pytree.tree_flatten(
            self.fn(*values[:n], **dict(zip(self.kwargs, values[n:]))))
        return out


def sequential(fn, key: str = None, cpu_only: bool = False):
    """``fn``, called once per sequence under the batched step's
    ``torch.func.vmap`` (module docstring); its tensor arguments are
    top-level ones.  ``key`` names
    ``fn`` for the operator (by default its qualified name and id)."""
    key = key or f"{getattr(fn, '__qualname__', type(fn).__name__)}:{id(fn)}"

    @functools.wraps(fn, updated=())  # fn may be a module: keep its __dict__ its own
    def run(*args, **kwargs):
        if not getattr(_state, "on", False):
            return fn(*args, **kwargs)
        tensors = [x for x in (*args, *kwargs.values()) if isinstance(x, torch.Tensor)]
        if not graphs._transformed(tensors) or (cpu_only and tensors[0].device.type != "cpu"):
            return fn(*args, **kwargs)
        call = _CALLS[key] = _Call(fn, args, kwargs)
        out = torch.ops.asdslam.sequential(tensors, key)
        return pytree.tree_unflatten(list(out), call.out_spec)

    return run


def _op(tensors: list[torch.Tensor], key: str) -> list[torch.Tensor]:
    return _CALLS[key](tensors)


def _vmap_rule(info, in_dims, tensors, key):
    dims = in_dims[0]
    outs = []
    for b in range(info.batch_size):
        # a fresh copy: the single step's inputs are allocations of their own
        # (aligned as such), which a slice of the batch is not
        one = [t if d is None else t.select(d, b).clone() for t, d in zip(tensors, dims)]
        outs.append(_CALLS[key](one))
    return [torch.stack(o) for o in zip(*outs)], [0] * len(outs[0])


if not hasattr(torch.ops.asdslam, "sequential"):  # once per process
    torch.library.custom_op("asdslam::sequential", mutates_args=())(_op)
    torch.library.register_vmap("asdslam::sequential", _vmap_rule)


# The step's operations whose bits a batch could change (module docstring).
matmul = sequential(torch.matmul, "matmul")
einsum = sequential(torch.einsum, "einsum")
sum = sequential(torch.sum, "sum")  # noqa: A001 (torch.sum's name, as batching.sum)
sin = sequential(torch.sin, "sin", cpu_only=True)
cos = sequential(torch.cos, "cos", cpu_only=True)
arccos = sequential(torch.arccos, "arccos", cpu_only=True)
atan2 = sequential(torch.atan2, "atan2", cpu_only=True)
log = sequential(torch.log, "log", cpu_only=True)
