"""Per-rank FLOPs, HBM bytes and collective bytes of one step, counted as
its ops run.

The counterpart of ``repro/roofline/collect.py`` and ``hlo_cost.py``
together.  The reference reads these off the optimized HLO of a compiled
step; an eager PyTorch step has no HLO, so ``collect_step`` runs the step
under ``StepCounter``, a ``TorchDispatchMode`` that prices each aten op as
it dispatches, as ``hlo_cost.py`` prices each HLO instruction:

* matmul-class ops (mm, bmm, addmm, baddbmm, convolution, SDPA and their
  backwards) at 2·M·N·K, by ``torch.utils.flop_counter``'s formulas;
* one FLOP per output element for the elementwise ops (``_ELEMENTWISE``,
  the counterparts of ``hlo_cost._ELEMENTWISE``), one per input element
  for reductions (``_REDUCTIONS``);
* an op that HLO spells as several (softmax, log-sum-exp, SiLU, their
  backwards: ``_COMPOSITE``) as its decomposition into the ops above;
* nothing, FLOPs or bytes, for views and the ops of ``_FREE``; every
  other op (copies, gathers, scatters, concatenation) moves bytes and
  does no arithmetic;
* a call that the card runs as fused kernels (``StepCounter.fused``, the
  one-card count's AdamW update) as its ops' FLOPs and, for bytes, its
  arguments and results alone.

Bytes are each op's operand bytes plus its result bytes (an op that
overwrites its first operand, ``_OVERWRITE``, does not read it), counting
only tensors above ``RESIDENT_BYTES``.  Collective bytes are the result bytes
of the ``_c10d_functional`` collectives, by kind, as the reference takes
a collective's result shape; ``wait_tensor`` is free, and so is a
collective over a group of one rank, which XLA would have removed.

Eager execution runs every iteration of a loop and every recompute of a
checkpointed block, so the counter sees each one: ``hlo_cost.py``'s
trip-count expansion has no counterpart here.

The counts are one rank's.  On DTensors the mode lets each op through
(``NotImplemented``), so DTensor's dispatch runs it and the mode then sees
the local op, at the rank's shard shape; DTensor's sharding propagation
runs each op again on ``FakeTensor``s at the global shape, and those are
not counted (the dry-run's local tensors are ``meta`` tensors, not
``FakeTensor``s).  The port's kernels launch through ctypes, which no
dispatch mode sees: a step is counted on the plain path, as the
reference's HLO counts ``dense_attention``.
"""
from __future__ import annotations

import torch
from torch._decomp import decomposition_table
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _disable_current_modes)
from torch.utils.flop_counter import flop_registry

from ..core.h100 import H100

# An eager op reads its operands from HBM and writes its result there: a
# tensor outlives the op that made it only in HBM, and L2 is a cache that
# the program does not place data into.  What one op may keep on chip is
# what one thread block may hold in shared memory, so a tensor of at most
# that size (norm statistics, masks, a decode step's small activations)
# is priced zero, as ``hlo_cost.VMEM_RESIDENT_BYTES`` prices what fits a
# TPU core's VMEM.
RESIDENT_BYTES = H100["smem_bytes_per_block"]

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "exp", "expm1", "log", "log1p", "tanh", "rsqrt", "sqrt", "pow",
    "reciprocal", "floor", "ceil", "round", "where", "eq", "ne", "lt",
    "le", "gt", "ge", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "sign", "cos", "sin", "clamp", "clamp_min", "clamp_max",
    "atan2", "sigmoid", "erf", "masked_fill", "fmod", "remainder",
}

_REDUCTIONS = {"sum", "mean", "amax", "amin", "prod", "argmax", "argmin",
               "any", "all", "cumsum", "cumprod", "var", "std"}

_COMPOSITE = {
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "logsumexp", "silu", "silu_backward",
    "gelu", "gelu_backward", "softplus", "softplus_backward",
    "sigmoid_backward", "tanh_backward", "native_layer_norm",
    "native_layer_norm_backward", "addcmul", "addcdiv", "lerp", "var_mean",
    "linalg_vector_norm",
}

# no arithmetic and no data moved: allocations, aliases the dispatcher
# does not mark as views, a scalar's read
_FREE = {"detach", "alias", "lift_fresh", "_unsafe_view", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "arange", "scalar_tensor", "_local_scalar_dense"}

# in-place ops that write their first operand without reading it
_OVERWRITE = {"copy_", "fill_", "zero_"}

# the _c10d_functional collectives, by the reference's kind names
KIND = {"all_gather_into_tensor": "all-gather",
        "all_gather_into_tensor_coalesced": "all-gather",
        "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
        "reduce_scatter_tensor": "reduce-scatter",
        "reduce_scatter_tensor_coalesced": "reduce-scatter",
        "all_to_all_single": "all-to-all"}


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or results (nested in tuples,
    lists and dicts), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _meta(x):
    """``x`` with each tensor replaced by an empty meta tensor of its shape,
    strides and dtype."""
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(map(_meta, x))
    return x


def _signature(x):
    """A hashable stand-in for an op's arguments: each tensor by its shape
    and dtype, which are all that a decomposition's FLOPs depend on."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in x.items())
    if isinstance(x, (tuple, list)):
        return tuple(map(_signature, x))
    return x


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _hbm_bytes(tree) -> int:
    return sum(b for b in map(_nbytes, _tensors(tree))
               if b > RESIDENT_BYTES)


def _elems(tree) -> int:
    return sum(t.numel() for t in _tensors(tree))


def _group_size(args) -> int:
    """The ranks of a functional collective's group (its last argument
    that is a string names it); a group of one moves nothing."""
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


class StepCounter(TorchDispatchMode):
    """Sums the priced FLOPs, HBM bytes and collective bytes of the ops
    dispatched under it (the module docstring says how each is priced)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective = {}
        self.n_collectives = {}
        self._flops_only = False   # a composite's pricer: no bytes
        self._composite = {}    # (op, signature) -> its decomposition's FLOPs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        operands = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in operands):
            return out
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            if name in KIND and _group_size(args) > 1:
                kind = KIND[name]
                self.collective[kind] = self.collective.get(kind, 0.0) + \
                    sum(map(_nbytes, _tensors(out)))
                self.n_collectives[kind] = \
                    self.n_collectives.get(kind, 0) + 1
            return out
        if func.is_view or name in _FREE:
            return out
        if not self._flops_only:
            read = operands[1:] if name in _OVERWRITE else operands
            self.bytes += _hbm_bytes(read) + _hbm_bytes(out)
        self.flops += self._price(func, name.rstrip("_"), args, kwargs, out,
                                  operands)
        return out

    def fused(self, fn, *args, reread=()):
        """Run ``fn(*args)`` counted as the fused kernels that run it on the
        card: its ops' FLOPs, and as bytes its arguments read once, its
        results written once and the tensors of ``reread`` read once more
        (those above ``RESIDENT_BYTES``), as ``hlo_cost.py`` prices a
        fusion by its operands and results; the temporaries of its ops
        stay on chip there.  Returns ``fn``'s result."""
        flops_only, self._flops_only = self._flops_only, True
        try:
            out = fn(*args)
        finally:
            self._flops_only = flops_only
        if not flops_only:
            self.bytes += _hbm_bytes((args, reread)) + _hbm_bytes(out)
        return out

    def _price(self, func, name, args, kwargs, out, operands) -> float:
        if func.overloadpacket in flop_registry:
            return float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        if name in ("max", "min"):   # a reduction, or the binary form
            name = "maximum" if len(operands) > 1 else "amax"
        if name in _ELEMENTWISE:
            return float(_elems(out))
        if name in _REDUCTIONS:
            return float(_elems(operands[:1]))
        if name in ("_to_copy", "copy"):   # a convert where dtypes differ
            res = _tensors(out)[:1]
            return float(_elems(res)) if res and operands and \
                res[0].dtype != operands[-1].dtype else 0.0
        if name in _COMPOSITE and func in decomposition_table:
            return self._decomposed(func, args, kwargs)
        return 0.0

    def _decomposed(self, func, args, kwargs) -> float:
        """The FLOPs of ``func``'s decomposition on these arguments' shapes,
        priced once per signature by a counter of its own on meta copies,
        with every other mode off: the decomposition's temporaries are
        made for the count alone, and no tracker of the step sees them."""
        key = (func, _signature(args), _signature(kwargs))
        if key not in self._composite:
            with _disable_current_modes():
                meta = (_meta(args), _meta(kwargs))
                pricer = StepCounter()
                pricer._flops_only = True
                with pricer:
                    decomposition_table[func](*meta[0], **meta[1])
            self._composite[key] = pricer.flops
        return self._composite[key]


def collective_bytes(counter: StepCounter) -> tuple[float, dict]:
    """Total collective bytes (one rank's) and the per-kind breakdown."""
    return float(sum(counter.collective.values())), dict(counter.collective)


def record(counter: StepCounter) -> dict:
    """A counter's sums under the reference's record keys, all one
    rank's: ``flops``, ``bytes_accessed``, ``collective_bytes``,
    ``collective_breakdown`` (bytes by kind) and ``n_collectives`` (calls
    by kind)."""
    total, per_kind = collective_bytes(counter)
    return {"flops": counter.flops, "bytes_accessed": counter.bytes,
            "collective_bytes": total, "collective_breakdown": per_kind,
            "n_collectives": dict(counter.n_collectives)}


def collect_step(fn, *args) -> dict:
    """Run ``fn(*args)`` once under a ``StepCounter``; return its
    ``record``."""
    counter = StepCounter()
    with counter:
        fn(*args)
    return record(counter)


__all__ = ["KIND", "RESIDENT_BYTES", "StepCounter", "collect_step",
           "collective_bytes", "record"]
