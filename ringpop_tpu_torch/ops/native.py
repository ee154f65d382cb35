"""ctypes loader for the native FarmHash32 oracle (``_native/farmhash.cc``).

The port's copy of ``ringpop_tpu/ops/native.py``, with one difference: a
failed build raises :class:`NativeBuildError`.  The JAX loader returns
``None`` and falls back to the pure-Python hash; here the C++ FarmHash is
what keeps the parity oracle (``parity/oracle.py``) and the host ring
(``models/ring/host.py``) independent of the code under test, so a
fallback to :mod:`ringpop_tpu_torch.ops.farmhash32` would hide the loss.

The library is compiled with ``g++`` at first use (never at import) into
``ringpop_tpu_torch/_build/`` (git-ignored), named by a digest of the
source, so an edited source is always rebuilt; a build writes a temporary
file and renames it into place, so processes that build at once never
load a half-written library.  It has a plain C interface (no pybind11).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Union

import numpy as np

SRC = Path(__file__).resolve().parent / "_native" / "farmhash.cc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# rp_replica_hashes copies the name into a 512-byte buffer
_REPLICA_NAME_MAX = 480

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The native FarmHash32 library could not be built or loaded."""


def _lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / ("libfarmhash-%s.so" % digest)


def _build(path: Path) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libfarmhash-", suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        try:
            subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", tmp], check=True,
                           capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeBuildError("native FarmHash32: compiler %r not found" % CXX) from e
        except subprocess.CalledProcessError as e:
            raise NativeBuildError(
                "native FarmHash32: %s failed (rc %d):\n%s" % (CXX, e.returncode, e.stderr)
            ) from e
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> ctypes.CDLL:
    """Load the native library, building it first if needed; raises
    :class:`NativeBuildError` when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeBuildError("native FarmHash32: cannot load %s: %s" % (path, e)) from e
        lib.rp_farmhash32.restype = ctypes.c_uint32
        lib.rp_farmhash32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rp_farmhash32_batch.restype = None
        lib.rp_farmhash32_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
        ]
        lib.rp_replica_hashes.restype = None
        lib.rp_replica_hashes.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def hash32(data: Union[bytes, str]) -> int:
    """Native farmhashmk::Hash32."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    return int(get_lib().rp_farmhash32(data, len(data)))


def hash32_batch(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Native hash of each row of a padded ``[B, L]`` uint8 matrix."""
    lib = get_lib()
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    lens64 = np.ascontiguousarray(lens, dtype=np.uint64)
    max_len = int(lens64.max(initial=0))
    if max_len > mat.shape[1]:
        raise ValueError("lens exceed matrix width (%d > %d)" % (max_len, mat.shape[1]))
    out = np.empty(mat.shape[0], dtype=np.uint32)
    lib.rp_farmhash32_batch(mat.ctypes.data, mat.shape[1], lens64.ctypes.data,
                            mat.shape[0], out.ctypes.data)
    return out


def replica_hashes(name: Union[bytes, str], replica_points: int) -> np.ndarray:
    """hash32(f"{name}{i}") for i in range(replica_points) — the ring's
    replica expansion (lib/ring/index.js:54-57).  A name too long for the
    C entry point's buffer is hashed string by string, natively too."""
    if isinstance(name, str):
        name = name.encode("utf-8")
    lib = get_lib()
    if len(name) > _REPLICA_NAME_MAX:
        return np.array([hash32(name + str(i).encode()) for i in range(replica_points)],
                        dtype=np.uint32)
    out = np.empty(replica_points, dtype=np.uint32)
    lib.rp_replica_hashes(name, len(name), replica_points, out.ctypes.data)
    return out
