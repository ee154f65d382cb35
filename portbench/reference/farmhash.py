"""FarmHash32 as ringpop-node calls it (``farmhash.hash32``), written from
the published algorithm: Google's farmhash.cc, namespace ``farmhashmk``,
``Hash32`` and its helpers ``Hash32Len0to4``, ``Hash32Len5to12``,
``Hash32Len13to24``, ``Mur`` and ``fmix``.

:func:`hash32` hashes one byte string in plain Python (every length).
:func:`hash32_rows` hashes many rows at once with PyTorch on any device:
``[R, L]`` uint8 rows, each with its own length, all longer than 24 bytes
(a membership checksum string always is).  32-bit words live in int64
tensors, every product is taken in two 16-bit halves so nothing overflows,
and each result is masked back to 32 bits.
"""

from __future__ import annotations

import torch

C1 = 0xCC9E2D51
C2 = 0x1B873593
M32 = 0xFFFFFFFF


# -- one string, plain Python -------------------------------------------------


def _rot(x: int, s: int) -> int:
    return x if s == 0 else ((x >> s) | (x << (32 - s))) & M32


def _fmix(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _mur(a: int, h: int) -> int:
    a = (a * C1) & M32
    a = _rot(a, 17)
    a = (a * C2) & M32
    h ^= a
    h = _rot(h, 19)
    return (h * 5 + 0xE6546B64) & M32


def _fetch(s: bytes, i: int) -> int:
    return int.from_bytes(s[i:i + 4], "little")


def hash32(s: bytes) -> int:
    """farmhashmk ``Hash32`` of ``s`` (``bytes``, or ``str`` as UTF-8)."""
    if isinstance(s, str):
        s = s.encode()
    n = len(s)
    if n <= 4:
        b, c = 0, 9
        for v in s:
            v = v - 256 if v > 127 else v  # signed char
            b = (b * C1 + v) & M32
            c ^= b
        return _fmix(_mur(b, _mur(n, c)))
    if n <= 12:
        a, b, c = n, n * 5, 9
        d = b
        a = (a + _fetch(s, 0)) & M32
        b = (b + _fetch(s, n - 4)) & M32
        c = (c + _fetch(s, (n >> 1) & 4)) & M32
        return _fmix(_mur(c, _mur(b, _mur(a, d))))
    if n <= 24:
        a = _fetch(s, (n >> 1) - 4)
        b = _fetch(s, 4)
        c = _fetch(s, n - 8)
        d = _fetch(s, n >> 1)
        e = _fetch(s, 0)
        f = _fetch(s, n - 4)
        h = (d * C1 + n) & M32
        a = (_rot(a, 12) + f) & M32
        h = (_mur(c, h) + a) & M32
        a = (_rot(a, 3) + c) & M32
        h = (_mur(e, h) + a) & M32
        a = (_rot((a + f) & M32, 12) + d) & M32
        h = (_mur(b, h) + a) & M32
        return _fmix(h)
    h, g = n, (C1 * n) & M32
    f = g
    a0, a1, a2, a3, a4 = (
        (_rot((_fetch(s, n - k) * C1) & M32, 17) * C2) & M32 for k in (4, 8, 16, 12, 20))
    h = (_rot(h ^ a0, 19) * 5 + 0xE6546B64) & M32
    h = (_rot(h ^ a2, 19) * 5 + 0xE6546B64) & M32
    g = (_rot(g ^ a1, 19) * 5 + 0xE6546B64) & M32
    g = (_rot(g ^ a3, 19) * 5 + 0xE6546B64) & M32
    f = (_rot((f + a4) & M32, 19) + 113) & M32
    for i in range(0, ((n - 1) // 20) * 20, 20):
        a, b, c, d, e = (_fetch(s, i + k) for k in (0, 4, 8, 12, 16))
        h = (h + a) & M32
        g = (g + b) & M32
        f = (f + c) & M32
        h = (_mur(d, h) + e) & M32
        g = (_mur(c, g) + a) & M32
        f = (_mur((b + e * C1) & M32, f) + d) & M32
        f = (f + g) & M32
        g = (g + f) & M32
    g = (_rot(g, 11) * C1) & M32
    g = (_rot(g, 17) * C1) & M32
    f = (_rot(f, 11) * C1) & M32
    f = (_rot(f, 17) * C1) & M32
    h = _rot((h + g) & M32, 19)
    h = (h * 5 + 0xE6546B64) & M32
    h = (_rot(h, 17) * C1) & M32
    h = _rot((h + f) & M32, 19)
    h = (h * 5 + 0xE6546B64) & M32
    return (_rot(h, 17) * C1) & M32


# -- many rows, PyTorch ---------------------------------------------------------


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` mod 2^32 for 32-bit ``x`` in int64, without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotv(x: torch.Tensor, s: int) -> torch.Tensor:
    return ((x >> s) | (x << (32 - s))) & M32


def _murv(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    a = _mul(_rotv(_mul(a, C1), 17), C2)
    return (_mul(_rotv(h ^ a, 19), 5) + 0xE6546B64) & M32


def _word_at(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[R] little-endian 32-bit words of ``rows`` at byte offsets ``pos``."""
    idx = pos[:, None] + torch.arange(4, device=rows.device)
    b = rows.gather(1, idx).to(torch.int64)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def hash32_rows(rows: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[R] int64 farmhashmk ``Hash32`` of each row's first ``lens[r]``
    bytes.  ``rows``: [R, L] uint8 with L a multiple of 4 and at least
    ``lens.max()``; every length above 24."""
    if rows.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=rows.device)
    n = lens.to(torch.int64)
    if bool((n <= 24).any()) or rows.shape[1] % 4 or rows.shape[1] < int(n.max()):
        raise ValueError("rows must be longer than 24 bytes, padded to whole words")
    b = rows.to(torch.int64).reshape(rows.shape[0], -1, 4)
    # word-major, so that each step reads whole rows of it
    words = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    words = words.t().contiguous()
    del b
    h = n.clone()
    g = _mul(n, C1)
    f = g.clone()
    a0, a1, a2, a3, a4 = (_mul(_rotv(_mul(_word_at(rows, n - k), C1), 17), C2)
                          for k in (4, 8, 16, 12, 20))
    h = (_mul(_rotv(h ^ a0, 19), 5) + 0xE6546B64) & M32
    h = (_mul(_rotv(h ^ a2, 19), 5) + 0xE6546B64) & M32
    g = (_mul(_rotv(g ^ a1, 19), 5) + 0xE6546B64) & M32
    g = (_mul(_rotv(g ^ a3, 19), 5) + 0xE6546B64) & M32
    f = (_rotv((f + a4) & M32, 19) + 113) & M32
    iters = (n - 1) // 20
    for k in range(int(iters.max())):
        live = k < iters
        a, bb, c, d, e = (words[5 * k + j] for j in range(5))
        h1 = (h + a) & M32
        g1 = (g + bb) & M32
        f1 = (f + c) & M32
        h1 = (_murv(d, h1) + e) & M32
        g1 = (_murv(c, g1) + a) & M32
        f1 = (_murv((bb + _mul(e, C1)) & M32, f1) + d) & M32
        f1 = (f1 + g1) & M32
        g1 = (g1 + f1) & M32
        h = torch.where(live, h1, h)
        g = torch.where(live, g1, g)
        f = torch.where(live, f1, f)
    g = _mul(_rotv(_mul(_rotv(g, 11), C1), 17), C1)
    f = _mul(_rotv(_mul(_rotv(f, 11), C1), 17), C1)
    h = (_mul(_rotv((h + g) & M32, 19), 5) + 0xE6546B64) & M32
    h = _mul(_rotv(h, 17), C1)
    h = (_mul(_rotv((h + f) & M32, 19), 5) + 0xE6546B64) & M32
    return _mul(_rotv(h, 17), C1)
