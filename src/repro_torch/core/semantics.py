"""Numpy semantics for ACG capabilities.

The compiler treats capabilities/mnemonics as semantics-free (§2.1.4); the
*simulator* — like the vendor cycle-accurate simulators the paper measures
with — is where semantics live.  Integer unary nonlinearities (SIGMOID/TANH
on i32) are computed in float and rounded, standing in for the fixed-point
units real accelerators ship.

The port's copy of ``repro.core.semantics``, with the same logic.
"""
from __future__ import annotations

import numpy as np

_BINARY = {
    "ADD": np.add,
    "SUB": np.subtract,
    "MUL": np.multiply,
    "MAX": np.maximum,
    "MIN": np.minimum,
}


def _div(a, b):
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        return np.where(b == 0, 0, np.floor_divide(a, np.where(b == 0, 1, b)))
    return np.divide(a, np.where(b == 0, 1, b))


def _unary(name: str, x):
    xf = x.astype(np.float64)
    if name == "RELU":
        r = np.maximum(xf, 0)
    elif name == "SIGMOID":
        r = 1.0 / (1.0 + np.exp(-xf))
    elif name == "TANH":
        r = np.tanh(xf)
    else:
        raise KeyError(name)
    if np.issubdtype(x.dtype, np.integer):
        return np.rint(r).astype(x.dtype)
    return r.astype(x.dtype)


def apply_elementwise(name: str, out_dtype, ins: list[np.ndarray]) -> np.ndarray:
    if name in _BINARY:
        return _BINARY[name](ins[0].astype(out_dtype), ins[1].astype(out_dtype))
    if name == "DIV":
        return _div(ins[0].astype(out_dtype), ins[1].astype(out_dtype))
    return _unary(name, ins[0]).astype(out_dtype)


def apply_mac(out_dtype, a: np.ndarray, b: np.ndarray, acc: np.ndarray,
              labels: tuple[str, str, str]) -> np.ndarray:
    """MAC/GEMM family: ``acc + einsum(a, b)`` with per-operand dim labels
    drawn from {m,n,k} (extent-1 dims squeezed by the caller)."""
    la, lb, lc = labels
    prod = np.einsum(f"{la},{lb}->{lc}",
                     a.astype(np.int64) if np.issubdtype(np.dtype(out_dtype), np.integer)
                     else a.astype(np.float64),
                     b.astype(np.int64) if np.issubdtype(np.dtype(out_dtype), np.integer)
                     else b.astype(np.float64))
    return (acc.astype(prod.dtype) + prod).astype(out_dtype)


MATMUL_FAMILY = ("MAC", "GEMM", "MVMUL", "MMUL")
ELEMENTWISE = ("ADD", "SUB", "MUL", "DIV", "MAX", "MIN", "RELU", "SIGMOID", "TANH")

__all__ = ["ELEMENTWISE", "MATMUL_FAMILY", "apply_elementwise", "apply_mac"]
