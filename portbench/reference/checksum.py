"""Membership checksums as the Node reference defines them, in PyTorch.

A node's checksum is FarmHash32 (:mod:`.farmhash`) of its checksum string:
the members it knows, sorted by address, each ``address + status +
incarnationNumber``, joined by ``;`` (ringpop-node lib/membership/index.js
``generateChecksumString``).  The engine keeps an incarnation as a tick
stamp ``s``; its number is the epoch-ms value ``epoch_ms + (s - 1) *
period_ms`` (0 when never asserted).

:func:`view_checksums` builds every row's string as bytes on the rows'
device (a block of rows at a time, each member's segment written at its
offset) and hashes all rows together.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import farmhash

STATUS_STRINGS = ("alive", "suspect", "faulty", "leave")
_SEP = ord(";")
_ZERO = ord("0")


def addresses(n: int, base_port: int = 3000, host: str = "127.0.0.1"):
    """The cluster's addresses in node order (the sorted order for
    ``n <= 7000``: every port has four digits)."""
    out = ["%s:%d" % (host, base_port + i) for i in range(n)]
    if out != sorted(out):
        raise ValueError("node order must be address order")
    return out


def stamp_to_ms(stamp: torch.Tensor, epoch_ms: int, period_ms: int) -> torch.Tensor:
    s = stamp.to(torch.int64)
    return torch.where(s > 0, epoch_ms + (s - 1) * period_ms, torch.zeros_like(s))


def _table(strings, device):
    """[K, W] uint8 bytes and [K] int64 lengths of ``strings``."""
    raw = [s.encode() for s in strings]
    width = max(len(r) for r in raw)
    buf = np.zeros((len(raw), width), np.uint8)
    for i, r in enumerate(raw):
        buf[i, :len(r)] = np.frombuffer(r, np.uint8)
    return (torch.as_tensor(buf, device=device),
            torch.tensor([len(r) for r in raw], dtype=torch.int64, device=device))


def _digits(ms: torch.Tensor, pow10: torch.Tensor) -> torch.Tensor:
    return 1 + (ms[..., None] >= pow10[1:]).sum(-1)


def view_checksums(addrs, known: torch.Tensor, status: torch.Tensor, inc_ms: torch.Tensor,
                   block: int = 256) -> torch.Tensor:
    """[R] int64 FarmHash32 of R views given as [R, N] ``known``,
    ``status`` and ``inc_ms`` (incarnation numbers) rows."""
    dev = known.device
    rows, n = known.shape
    a_bytes, a_len = _table(addrs, dev)
    s_bytes, s_len = _table(STATUS_STRINGS, dev)
    pow10 = torch.tensor([10 ** k for k in range(19)], dtype=torch.int64, device=dev)
    seg_max = int(a_len.max()) + int(s_len.max()) + 19 + 1
    p = torch.arange(seg_max, device=dev)

    def segments(r0, r1):
        st = status[r0:r1].to(torch.int64)
        ms = inc_ms[r0:r1].to(torch.int64)
        sl = s_len[st]
        dig = _digits(ms, pow10)
        seg = torch.where(known[r0:r1], a_len[None, :] + sl + dig + 1, 0)
        return st, ms, sl, dig, seg

    # every row's length first: one buffer holds all rows
    lens = torch.cat([segments(r0, min(rows, r0 + block))[4].sum(1) - 1
                      for r0 in range(0, rows, block)])
    width = (int(lens.max()) + 1 + 3) // 4 * 4
    out = torch.zeros((rows, width), dtype=torch.uint8, device=dev)
    flat = out.view(-1)
    for r0 in range(0, rows, block):
        r1 = min(rows, r0 + block)
        st, ms, sl, dig, seg = segments(r0, r1)
        off = torch.cumsum(seg, 1) - seg
        al = a_len[None, :, None]
        q = p[None, None, :]
        in_addr = q < al
        in_status = ~in_addr & (q < al + sl[..., None])
        end_digits = al + sl[..., None] + dig[..., None]
        in_digits = ~in_addr & ~in_status & (q < end_digits)
        addr_b = a_bytes[:, p.clamp(max=a_bytes.shape[1] - 1)][None].to(torch.int64)
        stat_b = s_bytes[st[..., None], (q - al).clamp(0, s_bytes.shape[1] - 1)].to(torch.int64)
        expo = (end_digits - 1 - q).clamp(0, 18)
        digit_b = _ZERO + (ms[..., None] // pow10[expo]) % 10
        byte = torch.where(in_addr, addr_b,
                           torch.where(in_status, stat_b,
                                       torch.where(in_digits, digit_b, _SEP)))
        valid = q < seg[..., None]
        row = torch.arange(r0, r1, device=dev)[:, None, None]
        at = row * width + off[..., None] + q
        flat[at[valid]] = byte[valid].to(torch.uint8)
    return farmhash.hash32_rows(out, lens)
