"""Build and bind the port's CUDA kernels (``ringpop_tpu_torch/csrc``).

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper), and the objects are linked into
one shared library with a plain C interface that :mod:`ctypes` loads — no
PyTorch headers, so a cold build takes seconds.  The library goes to
``ringpop_tpu_torch/_build/`` (git-ignored), named by a digest of the
sources, so an edited source is always rebuilt.  The build runs at the
first kernel launch, never at import.  A failed build raises; no wrapper
falls back to its plain version on a CUDA tensor.

Each C entry point takes a pointer table, the sizes and the CUDA stream,
launches one kernel on that stream and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


# each C entry point: its pointer-table length and its int arguments
ENTRY_POINTS = {
    "ringpop_apply_updates": (33, 3),
    "ringpop_pb_budget": (9, 2),
    "ringpop_fused_stream": (9, 3),
    "ringpop_exchange": (7, 8),
    "ringpop_block_loop": (8, 3),
}


class KernelLibrary:
    """The loaded shared library plus what its build cost.  Each C entry
    point is bound once, here, with its pointer-table type."""

    def __init__(self, path: Path, build_seconds: float, built: bool):
        self.path = path
        self.build_seconds = build_seconds
        self.built = built
        self.lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self._entry = {}
        for name, (n_ptrs, n_ints) in ENTRY_POINTS.items():
            fn = getattr(self.lib, name)
            fn.argtypes = [vp] + [ci] * n_ints + [vp]
            fn.restype = ctypes.c_int
            self._entry[name] = (fn, ctypes.c_void_p * n_ptrs)

    def call(self, name: str, ptrs: Sequence[int], *ints: int) -> None:
        """Launch ``name`` on the current stream and raise on a launch
        error.  ``ptrs`` are device pointers (0 for an absent optional)."""
        fn, table_type = self._entry[name]
        err = fn(table_type(*ptrs), *ints, _current_stream())
        if err != 0:
            raise RuntimeError(
                "%s: CUDA launch failed with cudaError %d" % (name, err)
            )


def _current_stream() -> int:
    """The raw handle of the current CUDA stream (what
    ``torch.cuda.current_stream().cuda_stream`` gives, without building a
    Stream object)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA toolkit is needed to build the port's kernels"
    )


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256()
    for p in sorted(list(srcs) + sorted(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> KernelLibrary:
    """Compile (if needed) and load the kernel library."""
    srcs = sources()
    out = BUILD / ("libringpop_kernels_%s.so" % _digest(srcs))
    if out.exists():
        return KernelLibrary(out, 0.0, built=False)
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        procs = []
        objs = []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [
                nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                "-I", str(CSRC), "-c", str(src), "-o", str(obj),
            ]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
            objs.append(str(obj))
        logs = []
        failed = []
        for src, p in procs:
            log, _ = p.communicate()
            logs.append("== %s ==\n%s" % (src.name, log))
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                "nvcc failed for %s:\n%s" % (", ".join(failed), "\n".join(logs))
            )
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n%s" % link.stdout)
        os.replace(tmp_so, out)
    if verbose:
        print("\n".join(logs))
    return KernelLibrary(out, time.perf_counter() - t0, built=True)


_LIB: Optional[KernelLibrary] = None


def library(verbose: bool = False) -> KernelLibrary:
    """The process's kernel library, built on first use (``verbose``
    prints nvcc's register and spill report when it builds)."""
    global _LIB
    if _LIB is None:
        _LIB = build(verbose)
    return _LIB


def ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def check(name: str, device, operands) -> None:
    """Validate kernel operands before their pointers cross into C, in one
    pass: ``operands`` holds ``(field, tensor, dtype, shape)`` tuples.  A
    message is formatted only when an operand is refused."""
    for field, t, dtype, shape in operands:
        if t.device != device or t.dtype != dtype or t.shape != shape or not t.is_contiguous():
            _refuse("%s: %s" % (name, field), t, dtype, shape, device)


def _refuse(what: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (what, t.device, device))
    if t.dtype != dtype:
        raise ValueError("%s has dtype %s, expected %s" % (what, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s" % (what, tuple(t.shape), tuple(shape)))
    raise ValueError("%s must be contiguous" % what)
