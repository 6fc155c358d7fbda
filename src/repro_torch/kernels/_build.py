"""Build the Hopper kernels from ``csrc/`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), in
``build/kernels/`` at the repository root.  A library's file name carries a
hash of its source, so an edited source is rebuilt and an unchanged one is
reused; the hash also covers the shared headers (``csrc/*.cuh``).
``build_all`` starts one ``nvcc`` per source, all together, and
waits for them; ``library`` builds one at its first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SOURCES = ("matmul", "flash_attention", "flash_attention_bwd",
           "flash_decode", "ssd_scan", "adamw")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, str], object] = {}
# ptxas resource report (registers, shared memory, spills) per built source
build_logs: dict[str, str] = {}


def _tool(name: str) -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``) on the PATH or in
    the toolkit's default place."""
    found = shutil.which(name)
    if found:
        return found
    default = f"/usr/local/cuda/bin/{name}"
    if os.path.exists(default):
        return default
    raise RuntimeError(f"{name} not found: the Hopper kernels build only "
                       f"where the CUDA toolkit is installed")


def _target(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source and
    of every ``csrc/*.cuh`` header, so that an edited header rebuilds the
    libraries that may include it."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp output, target)."""
    target = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, proc, tmp: str, target: Path) -> None:
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all() -> float:
    """Build every source not yet built, one nvcc each, all started
    together.  Returns the wall seconds it took."""
    t0 = time.perf_counter()
    jobs = [(n, *_start(n)) for n in SOURCES if not _target(n).exists()]
    errors = []
    for name, proc, tmp, target in jobs:
        try:
            _finish(name, proc, tmp, target)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def sass_counts(name: str) -> dict[str, int]:
    """How many tensor-core instructions the built library of
    ``csrc/<name>.cu`` holds, by opcode: ``HGMMA`` (wgmma), ``HMMA``
    (mma.sync on floats) and ``IMMA`` (mma.sync on integers), read from
    ``cuobjdump -sass``."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(_target(name))],
                         capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\.", out))
            for op in ("HGMMA", "HMMA", "IMMA")}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    target = _target(name)
    if not target.exists():
        _finish(name, *_start(name))
    lib = ctypes.CDLL(str(target))
    err_fn = getattr(lib, f"covenant_{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = getattr(library(name), f"covenant_{name}_error_string")(err)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg.decode()})")


def bind(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, typed: every
    entry point returns a CUDA error code as an int."""
    fn = _bound.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[(name, symbol)] = fn
    return fn


__all__ = ["BUILD_DIR", "SOURCES", "bind", "build_all", "build_logs",
           "check", "library", "sass_counts"]
