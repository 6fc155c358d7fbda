"""Datatype vocabulary shared by the ACG, Codelets and the tiler.

A copy of ``repro.core.dtypes`` with ``Dtype.jnp()`` replaced by
``Dtype.torch()``.

The paper's capability signatures are granularity-typed: ``(i16,2)=ADD((i16,2),(i16,2))``.
``Dtype`` carries the bit-width (drives Algorithm-1 alignment checks and
memory-occupancy accounting) plus numpy/torch views.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dtype:
    name: str
    bits: int
    kind: str  # "int" | "uint" | "float"

    @property
    def bytes(self) -> int:
        return max(1, self.bits // 8)

    @property
    def np(self) -> np.dtype:
        if self.name == "bf16":
            # numpy has no bfloat16; numpy views carry bf16 payloads in f32
            # and torch uses torch.bfloat16 natively.
            return np.dtype(np.float32)
        return np.dtype(self.name.replace("i", "int").replace("u", "uint").replace("f", "float"))

    def torch(self):
        import torch

        return {
            "i8": torch.int8, "u8": torch.uint8, "i16": torch.int16,
            "u16": torch.uint16, "i32": torch.int32, "u32": torch.uint32,
            "f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
        }[self.name]

    def __str__(self) -> str:  # matches the paper's rendering, e.g. "i16"
        return self.name


_REGISTRY = {
    "i8": Dtype("i8", 8, "int"),
    "u8": Dtype("u8", 8, "uint"),
    "i16": Dtype("i16", 16, "int"),
    "u16": Dtype("u16", 16, "uint"),
    "i32": Dtype("i32", 32, "int"),
    "u32": Dtype("u32", 32, "uint"),
    "f16": Dtype("f16", 16, "float"),
    "bf16": Dtype("bf16", 16, "float"),
    "f32": Dtype("f32", 32, "float"),
}


def dt(name: str) -> Dtype:
    """Look up a dtype by its paper-style name (``"i16"``, ``"bf16"`` ...)."""
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown dtype {name!r}; known: {sorted(_REGISTRY)}") from e


ALL_DTYPES = tuple(_REGISTRY.values())
