"""FarmHash32 (farmhashmk) over padded byte rows, on int32-view tensors.

Counterpart of ``ringpop_tpu/ops/jax_farmhash.py``: the constants, the
rotate/mix helpers, the three short-string buckets (0-4, 5-12 and 13-24
bytes) and the long-string path over a padded ``[B, W] uint8`` matrix with
per-row lengths.  :func:`hash32_rows` hashes each row; the long path's
20-byte block loop is :func:`ringpop_tpu_torch.ops.block_loop.block_loop`
(a CUDA kernel on the card), fed the aligned little-endian word view of
the byte matrix (:func:`pack_words`).

Every uint32 is an int32 bit pattern (:mod:`u32`).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ringpop_tpu_torch.ops import toolkit, u32
from ringpop_tpu_torch.ops.u32 import rotr, s32, srl

C1 = s32(0xCC9E2D51)
C2 = s32(0x1B873593)
FIVE = 5
MAGIC = s32(0xE6546B64)


def _rot(x: torch.Tensor, r: int) -> torch.Tensor:
    return rotr(x, r)


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ srl(h, 16)
    h = h * s32(0x85EBCA6B)
    h = h ^ srl(h, 13)
    h = h * s32(0xC2B2AE35)
    h = h ^ srl(h, 16)
    return h


def _mur(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    a = a * C1
    a = _rot(a, 17)
    a = a * C2
    h = h ^ a
    h = _rot(h, 19)
    return h * FIVE + MAGIC


def _fetch32(mat: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Per-row little-endian 4-byte fetch at (possibly unaligned) offsets."""
    off = off.clamp(0, mat.shape[1] - 4).to(torch.int64)
    idx = off[:, None] + torch.arange(4, dtype=torch.int64, device=mat.device)[None, :]
    b = torch.gather(mat, 1, idx).to(torch.int32)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def _hash_0_4(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    n = lens.to(torch.int32)
    B = mat.shape[0]
    b = torch.zeros(B, dtype=torch.int32, device=mat.device)
    c = torch.full((B,), 9, dtype=torch.int32, device=mat.device)
    for i in range(4):
        active = lens > i
        # signed char semantics: sign-extend bytes >= 0x80
        v = u32.signed_bytes(mat[:, min(i, mat.shape[1] - 1)])
        nb = b * C1 + v
        b = torch.where(active, nb, b)
        c = torch.where(active, c ^ nb, c)
    return _fmix(_mur(b, _mur(n, c)))


def _hash_5_12(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    n = lens.to(torch.int32)
    a = n + _fetch32(mat, torch.zeros_like(lens))
    b = n * FIVE + _fetch32(mat, lens - 4)
    c = 9 + _fetch32(mat, (lens >> 1) & 4)
    d = n * FIVE  # seed = 0
    return _fmix(_mur(c, _mur(b, _mur(a, d))))


def _hash_13_24(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    n = lens.to(torch.int32)
    a = _fetch32(mat, (lens >> 1) - 4)
    b = _fetch32(mat, torch.full_like(lens, 4))
    c = _fetch32(mat, lens - 8)
    d = _fetch32(mat, lens >> 1)
    e = _fetch32(mat, torch.zeros_like(lens))
    f = _fetch32(mat, lens - 4)
    h = d * C1 + n  # seed = 0
    a = _rot(a, 12) + f
    h = _mur(c, h) + a
    a = _rot(a, 3) + c
    h = _mur(e, h) + a
    a = _rot(a + f, 12) + d
    h = _mur(b, h) + a  # b ^ seed, seed = 0
    return _fmix(h)


def pack_words(mat: torch.Tensor) -> torch.Tensor:
    """``[B, L] uint8`` -> aligned little-endian ``[B, ceil(L/4)]`` int32
    (uint32) words: the same bytes reinterpreted in place when ``L`` is a
    multiple of 4 and the storage is 4-byte aligned, else one padded copy."""
    if sys.byteorder != "little":
        raise RuntimeError("pack_words assumes a little-endian host")
    pad = (-mat.shape[1]) % 4
    if pad:
        mat = torch.nn.functional.pad(mat, (0, pad))
    mat = mat.contiguous()
    if not toolkit.is_batched(mat) and mat.storage_offset() % 4:
        mat = mat.clone()
    return u32.bytes_to_words(mat)


def _hash_long(
    mat: torch.Tensor, words: torch.Tensor, lens: torch.Tensor, impl: Optional[str] = None
) -> torch.Tensor:
    """The > 24-byte path: tail mixes, the 20-byte block loop over the word
    view (no copy when the row already holds every block), final mixes."""
    from ringpop_tpu_torch.ops import block_loop as bl

    n32 = lens.to(torch.int32)
    h = n32
    g = C1 * n32
    f = g

    def tail(off_from_end: int) -> torch.Tensor:
        v = _fetch32(mat, lens - off_from_end)
        return _rot(v * C1, 17) * C2

    a0, a1, a2, a3, a4 = tail(4), tail(8), tail(16), tail(12), tail(20)
    h = h ^ a0
    h = _rot(h, 19) * FIVE + MAGIC
    h = h ^ a2
    h = _rot(h, 19) * FIVE + MAGIC
    g = g ^ a1
    g = _rot(g, 19) * FIVE + MAGIC
    g = g ^ a3
    g = _rot(g, 19) * FIVE + MAGIC
    f = f + a4
    f = _rot(f, 19) + 113

    iters = torch.div(n32 - 1, 20, rounding_mode="floor").to(torch.int32)
    max_iters = max((mat.shape[1] - 1) // 20, 1)
    need = 5 * max_iters
    w = words
    if w.shape[1] < need:
        w = torch.nn.functional.pad(w, (0, need - w.shape[1]))
    blocks = w[:, :need].reshape(w.shape[0], max_iters, 5)
    if impl == "plain":
        h, g, f = bl.block_loop_plain(h, g, f, blocks, iters)
    elif impl in (None, "kernel"):
        h, g, f = bl.block_loop(h, g, f, blocks, iters)
    else:
        raise ValueError("unknown hash32_rows impl %r" % (impl,))

    g = _rot(g, 11) * C1
    g = _rot(g, 17) * C1
    f = _rot(f, 11) * C1
    f = _rot(f, 17) * C1
    h = _rot(h + g, 19)
    h = h * FIVE + MAGIC
    h = _rot(h, 17) * C1
    h = _rot(h + f, 19)
    h = h * FIVE + MAGIC
    h = _rot(h, 17) * C1
    return h


def hash32_rows(
    mat: torch.Tensor, lens: torch.Tensor, impl: Optional[str] = None
) -> torch.Tensor:
    """farmhashmk::Hash32 of each padded row: ``[B]`` int32 (uint32).

    ``mat`` ``[B, W] uint8`` must carry >= 4 bytes of zero slack beyond the
    longest row.  ``impl``: "kernel" (:func:`block_loop.block_loop`: the CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor; also
    ``None``) or "plain" (:func:`block_loop.block_loop_plain`)."""
    mat = mat.to(torch.uint8)
    lens = lens.to(torch.int32)
    words = pack_words(mat)
    out = _hash_0_4(mat, lens)
    out = torch.where(lens > 4, _hash_5_12(mat, lens), out)
    out = torch.where(lens > 12, _hash_13_24(mat, lens), out)
    return torch.where(lens > 24, _hash_long(mat, words, lens, impl), out)


def hash32_strings(
    strings: Sequence[Union[bytes, str]], device="cpu", impl: Optional[str] = None
) -> np.ndarray:
    """Host convenience: encode on the host, hash on ``device``; returns
    numpy uint32."""
    from ringpop_tpu_torch.ops.farmhash32 import encode_rows

    mat, lens = encode_rows(strings)
    out = hash32_rows(
        torch.as_tensor(mat, device=device), torch.as_tensor(lens, device=device), impl
    )
    return u32.to_numpy(out)
