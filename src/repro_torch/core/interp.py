"""Functional interpreter for scheduled Codelets.

Executes the transformed Codelet (tile loops + transfers + mapped compute
ops) against numpy storage, one compute *invocation* at a time — the same
granularity the generated mnemonics have.  This is the correctness half of
the simulator; the cycle half is ``cost.py`` (analytic) and
``stream.py`` (per-mnemonic, for small streams).

Partial trailing invocations (ceil-tripped vector loops) are clamped to the
loop bound, matching the clamp semantics the code generator emits.

The port's copy of ``repro.core.interp``, with the same logic.
"""
from __future__ import annotations

import math

import numpy as np

from .acg import ACG
from .codelet import Aff, Codelet, Compute, Loop, Ref, Transfer
from .semantics import MATMUL_FAMILY, apply_elementwise, apply_mac


class InterpError(RuntimeError):
    pass


def run(cdlt: Codelet, acg: ACG, inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Execute the scheduled codelet; returns {out_name: array}."""
    store: dict[str, np.ndarray] = {}
    for s in cdlt.surrogates.values():
        if s.kind == "inp":
            a = np.asarray(inputs[s.name], dtype=s.dtype.np)
            if a.shape != s.shape:
                raise InterpError(f"{s.name}: expected {s.shape}, got {a.shape}")
            store[s.name] = a
        elif s.kind == "out":
            store[s.name] = np.zeros(s.shape, dtype=s.dtype.np)

    # loop bound map for clamping (rebuilt as we enter loops)
    bounds: dict[str, tuple[int, int]] = {}  # var -> (stride, stop)

    def eval_aff(ix: Aff, env) -> int:
        return ix.const + sum(c * env.get(var, 0) for var, c in ix.terms)

    def eff(var: str, gran: int, env) -> int:
        """Invocation extent along ``var``: the capability granularity,
        clamped by the loop bound (partial trailing invocation)."""
        _, stop = bounds.get(var, (1, 1 << 62))
        return max(1, min(gran, stop - env.get(var, 0)))

    def slice_spec(r: Ref, vec: dict[str, int], env):
        """Per-dim (start, count, step) honoring vectorized vars."""
        spec = []
        for ix in r.idx:
            vec_terms = [(var, c) for var, c in ix.terms if var in vec]
            start = eval_aff(ix, env)
            if not vec_terms:
                spec.append((start, 1, 1))
            elif len(vec_terms) == 1:
                var, c = vec_terms[0]
                spec.append((start, eff(var, vec[var], env), abs(c) or 1))
            else:
                raise InterpError(f"dim mixes vectorized vars: {ix}")
        return spec

    def read(r: Ref, vec, env) -> np.ndarray:
        a = store[r.var]
        if not r.idx:
            return a
        sl = tuple(slice(st, st + cnt * stp, stp)
                   for st, cnt, stp in slice_spec(r, vec, env))
        return a[sl]

    def write(r: Ref, vec, env, val: np.ndarray) -> None:
        a = store[r.var]
        if not r.idx:
            a[...] = val
            return
        sl = tuple(slice(st, st + cnt * stp, stp)
                   for st, cnt, stp in slice_spec(r, vec, env))
        a[sl] = val.reshape(a[sl].shape)

    def read_labeled(r: Ref, vec, role_of, env) -> tuple[np.ndarray, str]:
        """Slice + reshape to exactly the labeled (vectorized) dims."""
        a = store[r.var]
        if not r.idx:
            return a, ""
        spec = slice_spec(r, vec, env)
        sl = tuple(slice(st, st + cnt * stp, stp) for st, cnt, stp in spec)
        arr = a[sl]
        labels, shape = [], []
        for d, ix in enumerate(r.idx):
            vt = [var for var, _ in ix.terms if var in vec]
            if vt:
                labels.append(role_of[vt[0]])
                shape.append(arr.shape[d])
        return arr.reshape(tuple(shape)), "".join(labels)

    def exec_compute(op: Compute, env) -> None:
        vec = getattr(op, "vec", {}) or {}
        if op.capability in MATMUL_FAMILY:
            role_of = {}
            for role, vars_ in op.roles.items():
                for var in vars_:
                    if var in vec:
                        role_of[var] = role
            a, la = read_labeled(op.ins[0], vec, role_of, env)
            b, lb = read_labeled(op.ins[1], vec, role_of, env)
            acc, _ = read_labeled(op.ins[2] if len(op.ins) > 2 else op.out,
                                  vec, role_of, env)
            lc = read_labeled(op.out, vec, role_of, env)[1]
            res = apply_mac(op.dtype.np, a, b, acc, (la, lb, lc))
            write(op.out, vec, env, res)
        else:
            ins = [read(i, vec, env) for i in op.ins]
            res = apply_elementwise(op.capability, op.dtype.np, ins)
            write(op.out, vec, env, res)

    def exec_transfer(t: Transfer, env) -> None:
        if t.dst_loc is not None:
            s = cdlt.surrogates[t.alloc]
            if not t.src.var:  # const-fill allocation
                store[t.alloc] = np.full(s.shape, t.fill, dtype=s.dtype.np)
                return
            src = cdlt.surrogates[t.src.var]
            start = [eval_aff(ix, env) for ix in t.src.idx] or [0] * len(t.sizes)
            tile = np.zeros(t.sizes, dtype=s.dtype.np)
            src_arr = store[t.src.var]
            spans = [min(sz, src_arr.shape[d] - st)
                     for d, (st, sz) in enumerate(zip(start, t.sizes))]
            region = tuple(slice(st, st + sp) for st, sp in zip(start, spans))
            tile[tuple(slice(0, sp) for sp in spans)] = src_arr[region]
            store[t.alloc] = tile
        else:
            src_arr = store[t.src.var]
            dst = cdlt.surrogates[t.dst.var]
            start = [eval_aff(ix, env) for ix in t.dst.idx] or [0] * len(t.sizes)
            dst_arr = store[t.dst.var]
            spans = [min(sz, dst_arr.shape[d] - st)
                     for d, (st, sz) in enumerate(zip(start, t.sizes))]
            region = tuple(slice(st, st + sp) for st, sp in zip(start, spans))
            dst_arr[region] = src_arr[tuple(slice(0, sp) for sp in spans)]

    def exec_body(body: list, env: dict[str, int]) -> None:
        for item in body:
            if isinstance(item, Loop):
                bounds[item.var] = (item.stride, item.stop)
                x = item.start
                while x < item.stop:
                    env[item.var] = x
                    exec_body(item.body, env)
                    x += item.stride
                env.pop(item.var, None)
            elif isinstance(item, Transfer):
                exec_transfer(item, env)
            elif isinstance(item, Compute):
                exec_compute(item, env)

    exec_body(cdlt.body, {})
    return {s.name: store[s.name] for s in cdlt.surrogates.values() if s.kind == "out"}


__all__ = ["InterpError", "run"]
