"""Loop-aware cost model of the port: FLOPs, bytes and peak live bytes of
a step, counted from the aten ops it dispatches.

The counterpart of the reference's ``launch/costs.py::jaxpr_costs``, with
its categories and rules mapped onto aten ops.  ``traced_costs`` runs the
step under ``FakeTensorMode`` (shapes and dtypes only, nothing
allocated, like ``jax.eval_shape``) with a ``TorchDispatchMode`` on top
that sees every op:

  * dots (``mm``, ``bmm``, ``addmm``, ``baddbmm``, and the einsums and
    matmuls that lower to them): 2*b*m*n*k FLOPs; bytes of both operands
    plus the output;
  * convolutions: 2 * out elements * (in channels/groups * kernel) FLOPs;
    bytes of input, weight and output;
  * scatters (``index_put``, ``index_copy``, ``scatter``, ``scatter_add``):
    the bytes of the update only, not of the whole pool;
  * gathers (``index``, ``embedding``, ``index_select``, ``gather``): the
    bytes of the output plus the indices;
  * reductions (sums, means, amax/amin, argmax/argmin, cumsum, prod,
    sort; softmax and logsumexp as their max + sum lowering): the bytes of
    the input and one FLOP an element;
  * transcendental elementwise ops (exp, tanh, log, erf, sigmoid, rsqrt,
    sqrt, and silu/gelu/softplus by the one they apply): 4 FLOPs an
    output element.
Other ops (elementwise chains, copies, layout) add nothing: on the card
they fuse into, or are bounded by, the ops above, the reference's
post-fusion approximation.  Python loops need no trip multiplier, since
every iteration dispatches; a branch counts only if it runs.

Kernel regions are the counterpart of the reference's ``*_vmem_body``
scans: functions marked with :func:`kernel_region` (flash attention and
its recompute backward, the SSD and WKV scans, the vocab-tiled loss),
whose work on the card is one kernel or one tile loop.  Inside a region
FLOPs are counted and bytes are not; the region adds the bytes of its
tensor inputs and outputs.  A gather whose output reaches a region only
through views is not counted (its rows are read once, by the region).

Peak live bytes, the counterpart of ``compiled.memory_analysis()``: the
arguments' storages, plus every new output storage from its creation
until it is collected (views share their base's storage and count
once).  A region's intermediates are not counted, only its outputs.
"""
from __future__ import annotations

import functools
import math
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

aten = torch.ops.aten

_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_CONVS = {aten.convolution}
# op -> position of the update operand
_SCATTERS = {aten.index_put: 2, aten.index_put_: 2, aten.index_copy: 3,
             aten.index_copy_: 3, aten.scatter: 3, aten.scatter_: 3,
             aten.scatter_add: 3, aten.scatter_add_: 3}
_GATHERS = {aten.index, aten.embedding, aten.index_select, aten.gather}
_REDUCES = {aten.sum, aten.mean, aten.amax, aten.amin, aten.argmax, aten.argmin,
            aten.cumsum, aten.prod, aten.sort}
# counted as their lowering: a max and a sum over the input, an exp per
# element and, for logsumexp, a log per output element
_SOFTMAX = {aten._softmax, aten.logsumexp}
_TRANSCENDENTAL = {aten.exp, aten.tanh, aten.log, aten.erf, aten.sigmoid,
                   aten.rsqrt, aten.sqrt, aten.silu, aten.gelu, aten.softplus}

_counter = None      # the CostCounter in effect, if any


def kernel_region(fn):
    """Mark ``fn`` as a kernel region for :func:`traced_costs`.  Outside
    a count this costs one ``None`` check; it never changes a result."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _counter is None:
            return fn(*args, **kwargs)
        return _counter.region(fn, args, kwargs)
    return wrapper


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _key(t) -> int:
    return t.untyped_storage()._cdata


class _Storage:
    __slots__ = ("nbytes", "counted", "gather_bytes", "fed")

    def __init__(self, nbytes, counted, gather_bytes=0):
        self.nbytes, self.counted = nbytes, counted
        self.gather_bytes, self.fed = gather_bytes, False


class CostCounter(TorchDispatchMode):
    """The dispatch mode behind :func:`traced_costs`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.depth = 0                       # kernel regions entered
        self.storages: Dict[int, _Storage] = {}

    # ------------------------------------------------------- storages ---
    def track(self, t, counted=True, gather_bytes=0):
        """Register ``t``'s storage if it is new: live from now until ``t``
        is collected (a view keeps its base alive)."""
        key = _key(t)
        if key in self.storages:
            return
        rec = _Storage(t.untyped_storage().nbytes(), counted, gather_bytes)
        self.storages[key] = rec
        if counted:
            self._grow(rec.nbytes)
        weakref.finalize(t, self._free, key, rec).atexit = False

    def _grow(self, n):
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key, rec):
        if self.storages.get(key) is rec:
            del self.storages[key]
        if rec.counted:
            self.live -= rec.nbytes
        self._settle(rec)

    def _settle(self, rec):
        if rec.gather_bytes and not rec.fed:
            self.bytes += rec.gather_bytes
        rec.gather_bytes = 0

    def finish(self):
        """Settle the gathers whose outputs are still alive."""
        for rec in list(self.storages.values()):
            self._settle(rec)

    # --------------------------------------------------------- regions ---
    def region(self, fn, args, kwargs):
        inputs = _tensors((args, kwargs))
        if self.depth == 0:
            self.bytes += sum(_nbytes(t) for t in inputs)
            for t in inputs:
                rec = self.storages.get(_key(t))
                if rec is not None:
                    rec.fed = True
        self.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.depth -= 1
        if self.depth == 0:
            outputs = _tensors(out)
            self.bytes += sum(_nbytes(t) for t in outputs)
            for t in outputs:
                rec = self.storages.get(_key(t))
                if rec is not None and not rec.counted:
                    rec.counted = True
                    self._grow(rec.nbytes)
        return out

    # -------------------------------------------------------- dispatch ---
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = func.overloadpacket
        outs = _tensors(out)
        inside = self.depth > 0
        gather = 0
        if op in _DOTS:
            a, b = args[1:3] if op in (aten.addmm, aten.baddbmm) else args[:2]
            self.flops += 2.0 * outs[0].numel() * a.shape[-1]
            if not inside:
                self.bytes += _nbytes(a) + _nbytes(b) + _nbytes(outs[0])
        elif op in _CONVS:
            w = args[1]
            self.flops += 2.0 * outs[0].numel() * math.prod(w.shape[1:])
            if not inside:
                self.bytes += _nbytes(args[0]) + _nbytes(w) + _nbytes(outs[0])
        elif op in _SCATTERS:
            upd = args[_SCATTERS[op]]             # a scalar for scatter.value
            if isinstance(upd, torch.Tensor) and not inside:
                self.bytes += _nbytes(upd)
        elif op in _GATHERS:
            if not inside:
                idx = args[1] if op in (aten.index, aten.embedding) else args[2]
                self.bytes += sum(_nbytes(t) for t in _tensors(idx))
                gather = _nbytes(outs[0])
        elif op in _REDUCES:
            x = args[0]
            self.flops += x.numel()
            if not inside:
                self.bytes += _nbytes(x)
        elif op in _SOFTMAX:
            x = args[0]
            self.flops += 6.0 * x.numel()
            if op is aten.logsumexp:
                self.flops += 4.0 * outs[0].numel()
            if not inside:
                self.bytes += 2 * _nbytes(x)
        elif op in _TRANSCENDENTAL:
            self.flops += 4.0 * sum(t.numel() for t in outs)
        for t in outs:
            self.track(t, counted=not inside, gather_bytes=gather)
        return out


def fake_mode():
    """A new ``FakeTensorMode``: tensors made inside it have shapes,
    dtypes and devices but no storage; hand them to :func:`traced_costs`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def traced_costs(fn, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` under fake tensors and count its costs:
    ``{"flops", "bytes", "peak_bytes"}``.  ``args`` are pytrees of fake
    tensors (from one :func:`fake_mode`) or of real tensors, which are
    faked first; nothing is allocated or computed."""
    global _counter
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensor
    if _counter is not None:
        raise RuntimeError("traced_costs does not nest")
    mode = detect_fake_mode(args) or fake_mode()
    args = tree_map(lambda x: mode.from_tensor(x) if isinstance(x, torch.Tensor)
                    and not isinstance(x, FakeTensor) else x, args)
    counter = CostCounter()
    with mode, counter:
        for t in _tensors(args):
            counter.track(t)
        _counter = counter
        try:
            out = fn(*args)
        finally:
            _counter = None
        del out
    counter.finish()
    return {"flops": counter.flops, "bytes": counter.bytes,
            "peak_bytes": float(counter.peak)}
