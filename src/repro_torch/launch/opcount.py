"""The op counter of the dry run's layout and pp records: what
``FlopCounterMode`` does not give for a step run on ``meta`` tensors.

The JAX package reads these figures off XLA's compiled program. The port
runs the step instead, and ``OpCounter``, a ``TorchDispatchMode``, sees
each aten op as it runs:

* FLOPs — each elementwise op (an op tagged ``pointwise``) counts its
  output's elements, one FLOP each, as XLA's HLO cost counts an elementwise
  op; each reduction, scan, scatter-add and softmax counts its input's
  elements. The matrix products stay with ``FlopCounterMode`` (the ops of
  its ``flop_registry`` count nothing here), and the hand-written kernels'
  meta routes add their own. Copies, gathers, views and sorts count no
  FLOPs;
* HBM bytes — the sum over the ops of their tensor inputs' and outputs'
  bytes, each read and written once: an upper bound, since nothing is
  fused (the JAX package calls its CPU-HLO bytes one too). Views and
  allocations move nothing and count nothing;
* peak live bytes — the high-water mark of the bytes of the storages alive
  at once: the ``live`` tensors the counter is given (a step's inputs),
  every storage an op reads or writes, each counted from the first time it
  is seen until its last tensor dies (a weak reference to the storage,
  kept by PyTorch as long as the storage lives, tells). Outside the
  counter PyTorch's own ``torch.distributed._tools.mem_tracker`` also
  takes meta tensors; this one counts in the same pass as the FLOPs and
  bytes, and reads no private module.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# ops whose FLOPs are their input's elements
_INPUT_FLOPS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
                "argmax", "argmin", "any", "all", "logsumexp", "cumsum",
                "cumprod", "linalg_vector_norm", "norm", "var", "std",
                "var_mean", "std_mean", "_softmax", "_log_softmax",
                "_softmax_backward_data", "_log_softmax_backward_data",
                "index_add", "index_add_", "scatter_add", "scatter_add_",
                "scatter_reduce", "scatter_reduce_", "segment_reduce"}
# ops that allocate or alias without moving a byte
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_unsafe_view"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """``with OpCounter(live) as oc: step()`` → ``oc.flops``, ``oc.bytes``,
    ``oc.peak_bytes`` (see the module docstring); ``live`` the tensors
    alive through the step that it may not touch at once (its inputs)."""

    def __init__(self, live=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}
        for t in _tensors(live):
            self._see(t)
        self.peak_bytes = self.live_bytes

    def _see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace != "aten":           # collectives: counted apart
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = func.overloadpacket.__name__
        if func.overloadpacket in flop_registry:
            pass                               # FlopCounterMode's
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif name in _INPUT_FLOPS:
            self.flops += max((t.numel() for t in ins), default=0)
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in ins + outs:
            self._see(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out
