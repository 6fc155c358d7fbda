"""Codelets — the paper's §3 compute-kernel abstraction.

A Codelet declares parametric-shaped *surrogate variables* (``inp`` / ``out``
/ ``param``; ``local`` surrogates appear during compilation) and a body of
``loop`` / ``compute`` / ``transfer`` operations.  Codelets start
architecture-agnostic (``dtype``/``loc`` = None) and are *gradually
transformed* by the Covenant pipeline: layer mapping binds params and dtypes
(Fig 7b), compute mapping assigns ACG compute nodes, tiling splits loops, and
transfer insertion materialises data movement (Fig 8c).

Index arithmetic is affine over loop variables (``a[mo+mi, ko+ki]``), which is
sufficient for the paper's benchmark set (GEMM / CONV / elementwise / MLP
layers) and keeps footprint analysis exact.

The port's copy of ``repro.core.codelet``, with the same logic.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Iterator, Sequence

from .dtypes import Dtype, dt

# ---------------------------------------------------------------------------
# Affine index expressions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Aff:
    """Affine expression: sum(coeff * loop_var) + const."""

    terms: tuple[tuple[str, int], ...] = ()
    const: int = 0

    @staticmethod
    def of(x: "Aff | str | int") -> "Aff":
        if isinstance(x, Aff):
            return x
        if isinstance(x, str):
            return Aff(((x, 1),), 0)
        return Aff((), int(x))

    def __add__(self, other) -> "Aff":
        o = Aff.of(other)
        d = dict(self.terms)
        for v, c in o.terms:
            d[v] = d.get(v, 0) + c
        return Aff(tuple(sorted((v, c) for v, c in d.items() if c)), self.const + o.const)

    __radd__ = __add__

    def __mul__(self, k: int) -> "Aff":
        return Aff(tuple((v, c * k) for v, c in self.terms), self.const * k)

    __rmul__ = __mul__

    def vars(self) -> set[str]:
        return {v for v, _ in self.terms}

    def eval(self, env: dict[str, int]) -> int:
        return self.const + sum(c * env[v] for v, c in self.terms)

    def __str__(self) -> str:
        parts = [f"{v}" if c == 1 else f"{c}*{v}" for v, c in self.terms]
        if self.const or not parts:
            parts.append(str(self.const))
        return "+".join(parts)


def v(name: str) -> Aff:
    return Aff.of(name)


# ---------------------------------------------------------------------------
# Surrogates (§3.1)
# ---------------------------------------------------------------------------

KINDS = ("inp", "out", "param", "local", "const")


@dataclasses.dataclass
class Surrogate:
    """A single-location variable carrying shape, dtype and ACG location."""

    name: str
    kind: str
    shape: tuple[int, ...] | None = None
    dtype: Dtype | None = None
    loc: str | None = None
    value: object = None  # param value / const fill value

    def __post_init__(self):
        assert self.kind in KINDS, self.kind

    @property
    def elems(self) -> int:
        assert self.shape is not None, f"surrogate {self.name} has unbound shape"
        return math.prod(self.shape)

    @property
    def bits(self) -> int:
        assert self.dtype is not None, f"surrogate {self.name} has unbound dtype"
        return self.elems * self.dtype.bits

    def __str__(self) -> str:
        shp = "?" if self.shape is None else list(self.shape)
        return (f"{self.name}={self.kind}({shp},{self.dtype or 'null'},"
                f"{self.loc or 'null'})")


@dataclasses.dataclass(frozen=True)
class Ref:
    """Reference to a surrogate with affine per-dim offsets.

    ``sizes`` (when set) is the extent read/written per dim starting at the
    offset — transfers carry it explicitly (paper: "the transfer size in
    number of source elements in each dimension").
    """

    var: str
    idx: tuple[Aff, ...] = ()
    sizes: tuple[int, ...] | None = None

    def __str__(self) -> str:
        s = self.var
        if self.idx:
            s += "[" + ",".join(str(i) for i in self.idx) + "]"
        return s


def ref(var: str | Surrogate, *idx, sizes: Sequence[int] | None = None) -> Ref:
    name = var.name if isinstance(var, Surrogate) else var
    return Ref(name, tuple(Aff.of(i) for i in idx),
               tuple(sizes) if sizes is not None else None)


# ---------------------------------------------------------------------------
# Operations (§3.2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Loop:
    var: str
    start: int
    stop: int
    stride: int = 1
    body: list = dataclasses.field(default_factory=list)
    # marks loops produced by tiling splits (outer) and their inner twins
    role: str = "orig"  # "orig" | "tile" | "intra" | "unrolled"

    @property
    def trips(self) -> int:
        return max(0, math.ceil((self.stop - self.start) / self.stride))

    def __str__(self) -> str:
        return f"loop {self.var}({self.start},{self.stop},{self.stride})"


@dataclasses.dataclass
class Compute:
    capability: str
    out: Ref
    ins: tuple[Ref, ...]
    loc: str | None = None  # ACG compute node once mapped
    # loop-var role groups used by vectorization/tiling to align codelet loops
    # with capability geometry:  {"m": [...], "n": [...], "k": [...]} for the
    # matmul family, {"n": [...]} for elementwise lanes.
    roles: dict = dataclasses.field(default_factory=dict)
    # capability object chosen by compute mapping (granularity/geometry info)
    cap_obj: object = None
    dtype: object = None  # output Dtype, bound at layer mapping

    def __str__(self) -> str:
        ins = ",".join(str(i) for i in self.ins)
        return f'{self.out}=compute({self.loc or "null"},"{self.capability}",{ins})'


@dataclasses.dataclass
class Transfer:
    """Three paper forms:

    * ``dst_loc`` set, ``alloc`` set      — move src tile to a memory node,
      creating a new ``local`` surrogate (``x1=transfer(x[n],"MEM2",[2])``).
    * ``src`` is a const Ref (var=="") + ``alloc``  — allocate zero-filled
      local (``c1=transfer(i16(0),"MEM2",[2])``).
    * ``dst`` set                          — overwrite existing surrogate
      (``transfer(c1, c[n], [2])``).
    """

    src: Ref
    sizes: tuple[int, ...]
    dst_loc: str | None = None
    dst: Ref | None = None
    alloc: str | None = None  # name of the local surrogate created
    fill: object = None       # const fill value for allocation form

    def __str__(self) -> str:
        if self.dst_loc is not None:
            src = f"{self.src}" if self.src.var else f"fill({self.fill})"
            return (f'{self.alloc}=transfer({src},"{self.dst_loc}",'
                    f"{list(self.sizes)})")
        return f"transfer({self.src},{self.dst},{list(self.sizes)})"


Op = Loop | Compute | Transfer


# ---------------------------------------------------------------------------
# Codelet container
# ---------------------------------------------------------------------------


class Codelet:
    def __init__(self, name: str):
        self.name = name
        self.surrogates: dict[str, Surrogate] = {}
        self.body: list[Op] = []
        # Filled by the Covenant pipeline:
        self.tiling: dict[str, int] = {}       # loop var -> tile size
        self.schedule_notes: list[str] = []    # human-readable pass log
        # numpy reference oracle: {inp_name: arr} -> {out_name: arr}
        self.oracle = None

    # -- declaration API (used by the layer library) -------------------------
    def param(self, name: str, value=None) -> Surrogate:
        return self._add(Surrogate(name, "param", value=value))

    def inp(self, name: str, shape=None, dtype=None, loc=None) -> Surrogate:
        return self._add(Surrogate(name, "inp", _shp(shape), _dt(dtype), loc))

    def out(self, name: str, shape=None, dtype=None, loc=None) -> Surrogate:
        return self._add(Surrogate(name, "out", _shp(shape), _dt(dtype), loc))

    def local(self, name: str, shape, dtype, loc) -> Surrogate:
        return self._add(Surrogate(name, "local", _shp(shape), _dt(dtype), loc))

    def _add(self, s: Surrogate) -> Surrogate:
        if s.name in self.surrogates:
            raise ValueError(f"duplicate surrogate {s.name!r} in codelet {self.name}")
        self.surrogates[s.name] = s
        return s

    def fresh_name(self, base: str) -> str:
        i = 1
        while f"{base}{i}" in self.surrogates:
            i += 1
        return f"{base}{i}"

    # -- traversal -----------------------------------------------------------
    def walk(self) -> Iterator[tuple[list[Loop], Op]]:
        """Yield (enclosing_loops, op) in program order."""

        def rec(ops, stack):
            for op in ops:
                yield stack, op
                if isinstance(op, Loop):
                    yield from rec(op.body, stack + [op])

        yield from rec(self.body, [])

    def loops(self) -> list[Loop]:
        return [op for _, op in self.walk() if isinstance(op, Loop)]

    def computes(self) -> list[tuple[list[Loop], Compute]]:
        return [(ls, op) for ls, op in self.walk() if isinstance(op, Compute)]

    def transfers(self) -> list[tuple[list[Loop], Transfer]]:
        return [(ls, op) for ls, op in self.walk() if isinstance(op, Transfer)]

    def loop(self, var: str) -> Loop:
        for l in self.loops():
            if l.var == var:
                return l
        raise KeyError(f"no loop {var!r} in codelet {self.name}")

    def clone(self) -> "Codelet":
        return copy.deepcopy(self)

    def note(self, msg: str) -> None:
        self.schedule_notes.append(msg)

    # -- pretty printer (paper syntax) ---------------------------------------
    def __str__(self) -> str:
        lines = [f"cdlt {self.name} {{"]
        for s in self.surrogates.values():
            if s.kind in ("inp", "out", "param"):
                lines.append(f"  {s};")

        def emit(ops, ind):
            for op in ops:
                if isinstance(op, Loop):
                    lines.append(f"{' ' * ind}{op} {{")
                    emit(op.body, ind + 2)
                    lines.append(f"{' ' * ind}}}")
                else:
                    lines.append(f"{' ' * ind}{op};")

        emit(self.body, 2)
        lines.append("}")
        return "\n".join(lines)


def _shp(shape):
    return tuple(int(x) for x in shape) if shape is not None else None


def _dt(d):
    if d is None or isinstance(d, Dtype):
        return d
    return dt(d)


# ---------------------------------------------------------------------------
# Footprint analysis — how many elements of a surrogate one iteration of a
# given loop level touches; exact for affine indices with unit coefficients.
# ---------------------------------------------------------------------------


def ref_footprint(ref: Ref, surrogate: Surrogate, extents: dict[str, int]) -> tuple[int, ...]:
    """Per-dim element extent touched by ``ref`` when each loop var in
    ``extents`` ranges over [0, extent) and all other vars are fixed.

    ``ref.sizes`` (granularity of the access itself) multiplies in.
    """
    assert surrogate.shape is not None
    dims = []
    for d, ix in enumerate(ref.idx):
        span = 1
        for var, coeff in ix.terms:
            if var in extents:
                span += abs(coeff) * (extents[var] - 1)
        base = ref.sizes[d] if ref.sizes else 1
        dims.append(min(surrogate.shape[d], span - 1 + base))
    if not ref.idx:  # whole-surrogate reference
        return surrogate.shape
    return tuple(dims)


__all__ = [
    "Aff", "Codelet", "Compute", "Loop", "Op", "Ref", "Surrogate",
    "Transfer", "ref", "ref_footprint", "v",
]
