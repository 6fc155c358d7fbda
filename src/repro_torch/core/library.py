"""Codelet library: the paper's DNN-layer set.

Each builder returns a *layer-mapped* Codelet (Fig 7b): shapes/dtypes bound,
locations still ``null`` — exactly the state the Covenant pipeline starts
from.  ``PAPER_LAYERS`` instantiates Table 2 verbatim (BERT-Large GEMM +
attention GEMMs, DLRM FCs, InceptionV3 / MobileNetV3 / ResNet-50 convs+FCs);
N is sequence length for language models and batch size otherwise; INT8
inputs/weights, INT32 outputs (§5.1).

The port's copy of ``repro.core.library``, with the same logic.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .codelet import Codelet, Compute, Loop, Transfer, ref, v
from .dtypes import dt

# ---------------------------------------------------------------------------
# generic builders
# ---------------------------------------------------------------------------


def elementwise(op: str, n: int, dtype: str = "i32", arity: int = 2) -> Codelet:
    """``add``/``mul``/``relu``/... over flat length-n tensors (Fig 7)."""
    c = Codelet(f"{op.lower()}{n}")
    c.param("N", n)
    a = c.inp("a", [n], dtype)
    srcs = [a]
    if arity == 2:
        srcs.append(c.inp("b", [n], dtype))
    o = c.out("c", [n], dtype)
    body = Compute(op.upper(), ref(o, v("n")),
                   tuple(ref(s, v("n")) for s in srcs),
                   roles={"n": ["n"]}, dtype=dt(dtype))
    c.body.append(Loop("n", 0, n, 1, [body]))

    def oracle(inputs, _op=op.upper(), _dt=dt(dtype)):
        from .semantics import apply_elementwise
        ins = [inputs["a"]] + ([inputs["b"]] if arity == 2 else [])
        return {"c": apply_elementwise(_op, _dt.np, [np.asarray(x) for x in ins])}

    c.oracle = oracle
    return c


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


def fc(cin: int, cout: int, batch: int = 1, name: str | None = None) -> Codelet:
    return gemm(batch, cout, cin, name=name or f"fc_{cin}x{cout}")


def conv2d(n: int, ih: int, iw: int, ic: int, oc: int, kh: int, kw: int,
           stride: int = 1, name: str | None = None) -> Codelet:
    """Direct convolution; output spatial dims derived from stride (VALID)."""
    oh = (ih - kh) // stride + 1
    ow = (iw - kw) // stride + 1
    c = Codelet(name or f"conv_{ih}x{iw}x{ic}_{oc}k{kh}s{stride}")
    for pname, val in (("N", n), ("IH", ih), ("IW", iw), ("IC", ic), ("OC", oc),
                       ("KH", kh), ("KW", kw), ("S", stride)):
        c.param(pname, val)
    x = c.inp("X", [n, ih, iw, ic], "i8")
    w = c.inp("W", [kh, kw, ic, oc], "i8")
    o = c.out("O", [n, oh, ow, oc], "i32")
    mac = Compute(
        "MAC",
        ref(o, v("b"), v("oh"), v("ow"), v("oc")),
        (
            ref(x, v("b"), v("oh") * stride + v("kh"), v("ow") * stride + v("kw"), v("ic")),
            ref(w, v("kh"), v("kw"), v("ic"), v("oc")),
            ref(o, v("b"), v("oh"), v("ow"), v("oc")),
        ),
        roles={"m": ["b", "oh", "ow"], "n": ["oc"], "k": ["kh", "kw", "ic"]},
        dtype=dt("i32"),
    )
    nest = mac
    for var, ub in (("ic", ic), ("kw", kw), ("kh", kh), ("oc", oc),
                    ("ow", ow), ("oh", oh), ("b", n)):
        nest = Loop(var, 0, ub, 1, [nest])
    c.body.append(nest)

    def oracle(inputs, _oh=oh, _ow=ow, _s=stride):
        x = np.asarray(inputs["X"]).astype(np.int64)
        w = np.asarray(inputs["W"]).astype(np.int64)
        nb, _, _, _ = x.shape
        khh, kww, icc, occ = w.shape
        out = np.zeros((nb, _oh, _ow, occ), dtype=np.int64)
        for i in range(khh):
            for j in range(kww):
                patch = x[:, i:i + _s * _oh:_s, j:j + _s * _ow:_s, :]
                out += np.einsum("bhwc,co->bhwo", patch, w[i, j])
        return {"O": out.astype(np.int32)}

    c.oracle = oracle
    return c


def relu(n: int, dtype: str = "i32") -> Codelet:
    return elementwise("RELU", n, dtype, arity=1)


# ---------------------------------------------------------------------------
# Table 2 — the paper's benchmark layer set
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    model: str
    layer: str
    build: object  # () -> Codelet

    @property
    def key(self) -> str:
        return f"{self.model}-{self.layer}"


def _bert(layer: str, m, n, k, heads=1):
    return LayerSpec("BERT-LG", layer,
                     lambda: gemm(m, n, k, heads=heads, name=f"bert_{layer.lower()}"))


PAPER_LAYERS: list[LayerSpec] = [
    # BERT-Large, sequence length 384 (Table 2 rows 1-6)
    _bert("GEMM1", 384, 4096, 1024),
    _bert("GEMM2", 384, 1024, 4096),
    _bert("ATN1-GEMM", 384, 64, 1024, heads=16),
    _bert("ATN2-GEMM", 384, 384, 64, heads=16),
    _bert("ATN3-GEMM", 384, 64, 384, heads=16),
    _bert("ATN4-GEMM", 384, 1024, 1024),
    # DLRM MLP stack (batch 1)
    LayerSpec("DLRM", "FC1", lambda: fc(745, 367, name="dlrm_fc1")),
    LayerSpec("DLRM", "FC2", lambda: fc(367, 512, name="dlrm_fc2")),
    LayerSpec("DLRM", "FC3", lambda: fc(512, 256, name="dlrm_fc3")),
    LayerSpec("DLRM", "FC4", lambda: fc(256, 1, name="dlrm_fc4")),
    # CNNs
    LayerSpec("InceptionV3", "FC1", lambda: fc(2048, 1000, name="incep_fc1")),
    LayerSpec("InceptionV3", "CONV1",
              lambda: conv2d(1, 299, 299, 3, 32, 3, 3, 2, name="incep_conv1")),
    LayerSpec("MobileNetV3", "CONV1",
              lambda: conv2d(1, 224, 224, 3, 16, 3, 3, 2, name="mbnet_conv1")),
    LayerSpec("MobileNetV3", "CONV2",
              lambda: conv2d(1, 112, 112, 16, 64, 3, 3, 1, name="mbnet_conv2")),
    LayerSpec("ResNet50", "FC1", lambda: fc(512, 1000, name="resnet_fc1")),
    LayerSpec("ResNet50", "CONV1",
              lambda: conv2d(1, 224, 224, 3, 64, 7, 7, 2, name="resnet_conv1")),
    LayerSpec("ResNet50", "CONV2",
              lambda: conv2d(1, 224, 224, 64, 64, 3, 3, 4, name="resnet_conv2")),
]


def paper_layer(key: str) -> Codelet:
    for spec in PAPER_LAYERS:
        if spec.key == key:
            return spec.build()
    raise KeyError(f"unknown paper layer {key!r}; known: {[s.key for s in PAPER_LAYERS]}")


__all__ = ["PAPER_LAYERS", "LayerSpec", "conv2d", "elementwise", "fc", "gemm",
           "paper_layer", "relu"]
