"""Codelet library: the GEMM codelet the tiler schedules.

A trimmed copy of ``repro.core.library`` holding ``gemm`` only, same logic:
C[h,m,n] += A[h,m,k] * B[h,k,n], with shapes and dtypes bound and
locations still ``null``, the state the Covenant pipeline starts from.
"""
from __future__ import annotations

import numpy as np

from .codelet import Codelet, Compute, Loop, ref, v
from .dtypes import dt


def gemm(m: int, n: int, k: int, *, heads: int = 1, name: str | None = None,
         in_dtype: str = "i8", acc_dtype: str = "i32") -> Codelet:
    """C[h,m,n] += A[h,m,k] * B[h,k,n] — the FC/GEMM/attention-GEMM workhorse.

    The single compute op is a scalar-granularity MAC; vectorization re-maps
    it onto whatever GEMM-family capability the target exposes (§3.2's
    capability decomposition in reverse).
    """
    c = Codelet(name or f"gemm_{m}x{n}x{k}" + (f"_h{heads}" if heads > 1 else ""))
    for pname, val in (("M", m), ("N", n), ("K", k), ("H", heads)):
        c.param(pname, val)
    hdims = [heads] if heads > 1 else []
    a = c.inp("A", hdims + [m, k], in_dtype)
    b = c.inp("B", hdims + [k, n], in_dtype)
    o = c.out("C", hdims + [m, n], acc_dtype)
    hidx = [v("h")] if heads > 1 else []
    mac = Compute(
        "MAC",
        ref(o, *hidx, v("m"), v("n")),
        (ref(a, *hidx, v("m"), v("k")), ref(b, *hidx, v("k"), v("n")),
         ref(o, *hidx, v("m"), v("n"))),
        roles={"m": ["m"], "n": ["n"], "k": ["k"]},
        dtype=dt(acc_dtype),
    )
    nest = Loop("m", 0, m, 1, [Loop("n", 0, n, 1, [Loop("k", 0, k, 1, [mac])])])
    if heads > 1:
        nest = Loop("h", 0, heads, 1, [nest])
    c.body.append(nest)

    def oracle(inputs, _acc=dt(acc_dtype)):
        a64 = np.asarray(inputs["A"]).astype(np.int64 if _acc.kind != "float" else np.float64)
        b64 = np.asarray(inputs["B"]).astype(a64.dtype)
        return {"C": (a64 @ b64).astype(_acc.np)}

    c.oracle = oracle
    return c


__all__ = ["gemm"]
