"""Stream machine: executes generated mnemonic streams byte-for-byte.

This is the reproduction's stand-in for the vendor cycle-accurate simulators
the paper measures with (Hexagon SDK simulator / DNNWeaver's open-source
simulator).  It owns the *semantics* of mnemonics — the compiler never does
(§2.1.4) — and provides two cycle counts:

* ``serial``  — one mnemonic at a time (sum of per-mnemonic cycles);
* ``packed``  — after VLIW packet formation (§4 Mnemonic Packing): greedy
  in-order packing with bounded hoisting, dependency analysis from the
  ``rd``/``wr`` byte intervals derived from field read/write annotations,
  and per-packet slot-class resources.

On targets with ``issue_slots == 1`` the two counts coincide.

The port's copy of ``repro.core.stream``, with the same logic.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .acg import ACG, Mnemonic
from .codelet import Codelet
from .codegen import Placement, Program
from .semantics import MATMUL_FAMILY, apply_elementwise

# ---------------------------------------------------------------------------
# machine state
# ---------------------------------------------------------------------------


class Machine:
    """Byte-addressable storage per ACG memory node."""

    def __init__(self, program: Program):
        self.program = program
        acg = program.acg
        self.buffers: dict[str, np.ndarray] = {}
        for m in acg.memory_nodes():
            need = max(m.capacity_bytes, program.memmap.cursor.get(m.name, 0))
            self.buffers[m.name] = np.zeros(need, dtype=np.uint8)

    # -- typed views over raw bytes ----------------------------------------
    def view(self, node: str, base: int, shape, byte_strides, dtype) -> np.ndarray:
        buf = self.buffers[node]
        return np.ndarray(tuple(shape), dtype=dtype, buffer=buf,
                          offset=base, strides=tuple(byte_strides))

    def place_view(self, p: Placement, dtype) -> np.ndarray:
        strides = tuple(s * p.itemsize for s in p.strides())
        return self.view(p.node, p.addr, p.shape, strides, dtype)

    # -- I/O -----------------------------------------------------------------
    def load_inputs(self, inputs: dict[str, np.ndarray]) -> None:
        cdlt = self.program.cdlt
        for s in cdlt.surrogates.values():
            if s.kind != "inp":
                continue
            p = self.program.memmap.places[s.name]
            arr = np.asarray(inputs[s.name], dtype=s.dtype.np)
            assert arr.shape == p.shape, (s.name, arr.shape, p.shape)
            self.place_view(p, s.dtype.np)[...] = arr

    def read_outputs(self) -> dict[str, np.ndarray]:
        cdlt = self.program.cdlt
        out = {}
        for s in cdlt.surrogates.values():
            if s.kind == "out":
                p = self.program.memmap.places[s.name]
                out[s.name] = self.place_view(p, s.dtype.np).copy()
        return out

    # -- per-mnemonic semantics ----------------------------------------------
    def execute(self, m: Mnemonic) -> None:
        kind = m.sem[0]
        if kind == "loopi":
            return
        if kind == "alloc":
            _, p, fill, dtype = m.sem
            self.place_view(p, dtype)[...] = fill
            return
        if kind == "xfer":
            _, src_p, dst_p, vals, itemsize = m.sem
            rows, rb = vals["ROWS"], vals["ROW_BYTES"]
            ss, ds = vals["SRC_STRIDE"], vals["DST_STRIDE"]
            sbuf, dbuf = self.buffers[src_p.node], self.buffers[dst_p.node]
            sa, da = vals["SRC_ADDR"], vals["DST_ADDR"]
            for r in range(rows):
                dbuf[da + r * ds: da + r * ds + rb] = \
                    sbuf[sa + r * ss: sa + r * ss + rb]
            return
        if kind == "compute":
            _, capname, ins, outv, out_np = m.sem
            if capname in MATMUL_FAMILY:
                self._mac(capname, ins, outv, out_np)
            else:
                arrs = [np.asarray(self._view_of(v)) for v in ins]
                res = apply_elementwise(capname, out_np, arrs)
                dst = self._view_of(outv, out_np)
                dst[...] = res.reshape(dst.shape)
            return
        raise ValueError(f"unknown mnemonic semantics {kind!r}")

    def _dtype_of_place(self, place: Placement):
        for s in self.program.cdlt.surrogates.values():
            if self.program.memmap.places.get(s.name) is place:
                return s.dtype.np
        return np.int32

    def _view_of(self, v: dict, dtype=None) -> np.ndarray:
        dt = dtype if dtype is not None else self._dtype_of_place(v["place"])
        shape = v["shape"] or (1,)
        strides = tuple(s * v["place"].itemsize for s in v["strides"]) or \
            (v["place"].itemsize,)
        return self.view(v["place"].node, v["base"], shape, strides, dt)

    def _mac(self, capname, ins, outv, out_np) -> None:
        a = np.asarray(self._view_of(ins[0]))
        b = np.asarray(self._view_of(ins[1]))
        accv = ins[2] if len(ins) > 2 else outv
        acc = np.asarray(self._view_of(accv))
        la, lb = ins[0]["labels"], ins[1]["labels"]
        lc = outv["labels"]
        wide = np.int64 if np.issubdtype(np.dtype(out_np), np.integer) else np.float64
        prod = np.einsum(f"{la or ''},{lb or ''}->{lc or ''}",
                         a.astype(wide), b.astype(wide))
        res = (acc.astype(wide) + prod).astype(out_np)
        dst = self._view_of(outv, out_np)
        dst[...] = res.reshape(dst.shape)


# ---------------------------------------------------------------------------
# VLIW packet formation (§4)
# ---------------------------------------------------------------------------

SLOT_CAPACITY = {"mem": 2, "ctrl": 1}


def _slot_of(m: Mnemonic, acg: ACG) -> str:
    if m.sem[0] in ("xfer", "alloc"):
        return "mem"
    if m.sem[0] == "loopi":
        return "ctrl"
    node = acg.compute(m.node)
    return node.slot or "exec"


def _conflict(a: Mnemonic, b: Mnemonic) -> bool:
    """RAW / WAR / WAW between two mnemonics (byte-interval overlap)."""

    def overlap(xs, ys):
        for nx, lx, hx in xs:
            for ny, ly, hy in ys:
                if nx == ny and lx < hy and ly < hx:
                    return True
        return False

    return (overlap(a.wr, b.rd) or overlap(a.rd, b.wr) or overlap(a.wr, b.wr))


def pack_stream(program: Program, window: int = 12) -> list[list[int]]:
    """Greedy in-order packet formation with bounded hoisting.

    Follows §4: open a packet with the next unissued mnemonic, then hoist
    later mnemonics that (a) fit a free slot-class resource and the issue
    width, and (b) are independent of every unissued mnemonic they jump
    over *and* of every packet member.
    """
    acg = program.acg
    ms = program.mnemonics
    n = len(ms)
    issued = [False] * n
    packets: list[list[int]] = []
    i = 0
    while i < n:
        if issued[i]:
            i += 1
            continue
        packet = [i]
        issued[i] = True
        slots = {_slot_of(ms[i], acg): 1}
        if acg.issue_slots > 1:
            jumped: list[int] = []
            for j in range(i + 1, min(i + 1 + window, n)):
                if issued[j]:
                    continue
                if len(packet) >= acg.issue_slots:
                    break
                cand = ms[j]
                cls = _slot_of(cand, acg)
                if slots.get(cls, 0) >= SLOT_CAPACITY.get(cls, 1):
                    jumped.append(j)
                    continue
                if any(_conflict(ms[k], cand) or _conflict(cand, ms[k])
                       for k in packet) or any(
                        _conflict(ms[k], cand) for k in jumped):
                    jumped.append(j)
                    continue
                packet.append(j)
                issued[j] = True
                slots[cls] = slots.get(cls, 0) + 1
        packets.append(packet)
        i += 1
    return packets


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamResult:
    outputs: dict[str, np.ndarray]
    serial_cycles: float
    packed_cycles: float
    n_mnemonics: int
    n_packets: int

    @property
    def packing_speedup(self) -> float:
        return self.serial_cycles / max(self.packed_cycles, 1e-9)


def run_stream(program: Program, inputs: dict[str, np.ndarray],
               pack: bool = True) -> StreamResult:
    machine = Machine(program)
    machine.load_inputs(inputs)
    serial = 0.0
    for m in program.mnemonics:
        machine.execute(m)
        serial += m.cycles
    if pack and program.acg.issue_slots > 1:
        packets = pack_stream(program)
        packed = float(sum(max(program.mnemonics[k].cycles for k in p) or 0
                           for p in packets))
        n_packets = len(packets)
    else:
        packed, n_packets = serial, len(program.mnemonics)
    return StreamResult(machine.read_outputs(), serial, packed,
                        len(program.mnemonics), n_packets)


__all__ = ["Machine", "StreamResult", "pack_stream", "run_stream"]
