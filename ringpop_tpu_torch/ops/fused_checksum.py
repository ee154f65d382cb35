"""Fused membership-checksum pipeline: per-member record encode, then a
streaming FarmHash32 over the records with no ``[B, row_bytes]`` buffer.

Counterpart of ``ringpop_tpu/ops/fused_checksum.py`` (lines 51-304):

1. **Record encode** (:func:`member_records` / :func:`member_records_at`):
   each member's ``addr + status + incarnation + ';'`` record is built
   elementwise at record granularity.  A record only changes when its
   ``(known, status, incarnation)`` cell changes, so the engine caches the
   bytes per (observer, subject) and re-encodes only changed cells.
2. **Fused assemble+hash** (:func:`fused_hash_rows`): the stream hash
   (:func:`ringpop_tpu_torch.ops.stream_hash.fused_stream`, a CUDA kernel
   on the card) walks each row's records as one 20-byte block stream; only
   the <= 28-byte head and 24-byte tail windows are gathered here, straight
   from the record words, for the short-length buckets and the tail mixes.

Output: the int32 view of ``hash32(checksum string)`` per row, bit-identical
to the JAX pipeline (tests/test_torch_hash.py).
"""

from __future__ import annotations

import functools
import sys
from typing import Optional

import numpy as np
import torch

from ringpop_tpu_torch.ops import checksum_encode as ce
from ringpop_tpu_torch.ops import farmhash as fh
from ringpop_tpu_torch.ops import stream_hash, u32

MAX_DIGITS = ce.MAX_DIGITS


def record_width(universe: ce.Universe, max_digits: int = MAX_DIGITS) -> int:
    """Static byte capacity of one member record:
    ``addr + status + digits + ';'`` (the stream never reads past
    ``len-1``, so the final record's trailing ';' is naturally dropped)."""
    return universe.addr_width + ce._STATUS_W + max_digits + 1


@functools.lru_cache(maxsize=16)
def _status_tables(device: torch.device):
    return (
        torch.as_tensor(ce.STATUS_LEN, device=device),
        torch.as_tensor(ce.STATUS_BYTES, device=device),
    )


def _universe_tables(universe: ce.Universe, width: int, device: torch.device):
    """(addr_pad [N, width] uint8, addr_len [N] int32) on ``device``,
    built once per (universe, width, device)."""
    cache = universe.__dict__.setdefault("_port_tables", {})
    key = (width, str(device))
    got = cache.get(key)
    if got is None:
        addr_pad = np.zeros((universe.n, width), np.uint8)
        addr_pad[:, : universe.addr_width] = universe.addr_bytes
        got = (
            torch.as_tensor(addr_pad, device=device),
            torch.as_tensor(universe.addr_len, device=device),
        )
        cache[key] = got
    return got


def _records_core(
    addr_pad: torch.Tensor,  # [..., R] uint8 — member address bytes, padded
    addr_len: torch.Tensor,  # [...] int32
    status: torch.Tensor,  # [...] int codes
    inc_ms: torch.Tensor,  # [...] int64 epoch-ms incarnations
    present: torch.Tensor,  # [...] bool
    max_digits: int,
    width: int,
):
    """Elementwise record build over any cell shape; returns
    (bytes [..., width] uint8 zero-padded past len, len [...] int32)."""
    dev = status.device
    status_len, status_bytes = _status_tables(dev)
    st = status.to(torch.int64)
    al = addr_len.to(torch.int32)
    sl = status_len[st]
    dl = ce._ndigits(inc_ms)
    rec_len = (al + sl + dl + 1) * present.to(torch.int32)

    pb = torch.arange(width, dtype=torch.int32, device=dev).expand(
        al.shape + (width,)
    )
    alb = al[..., None]
    slb = sl[..., None]
    dlb = dl[..., None]

    sbytes = status_bytes[st]  # [..., 7]
    digits = ce._digit_bytes(inc_ms, dl, max_digits)  # [..., D]

    s_off = pb - alb
    d_off = s_off - slb
    byte_status = torch.gather(
        sbytes, -1, s_off.clamp(0, ce._STATUS_W - 1).to(torch.int64)
    )
    byte_digit = torch.gather(
        digits, -1, d_off.clamp(0, max_digits - 1).to(torch.int64)
    )
    sep = torch.full_like(byte_digit, ord(";"))
    out = torch.where(
        pb < alb,
        addr_pad,
        torch.where(
            s_off < slb,
            byte_status,
            torch.where(d_off < dlb, byte_digit, sep),
        ),
    )
    out = torch.where(pb < rec_len[..., None], out, torch.zeros_like(out))
    return out.to(torch.uint8), rec_len


def member_records(
    universe: ce.Universe,
    present: torch.Tensor,  # [..., N] bool
    status: torch.Tensor,  # [..., N] int codes
    inc_ms: torch.Tensor,  # [..., N] int64
    max_digits: int = MAX_DIGITS,
):
    """Dense per-member records for full rows (member = last-axis index).

    Returns ``(rec_bytes [..., N, R] uint8, rec_len [..., N] int32)``;
    absent members have length 0 and all-zero bytes."""
    width = record_width(universe, max_digits)
    addr_pad, addr_len = _universe_tables(universe, width, present.device)
    lead = tuple(present.shape[:-1])
    ap = addr_pad.expand(lead + tuple(addr_pad.shape))
    al = addr_len.expand(lead + (universe.n,))
    return _records_core(ap, al, status, inc_ms, present, max_digits, width)


def member_records_at(
    universe: ce.Universe,
    subject: torch.Tensor,  # [...] member (universe) indices
    status: torch.Tensor,
    inc_ms: torch.Tensor,
    present: torch.Tensor,
    max_digits: int = MAX_DIGITS,
):
    """Sparse form: records for an arbitrary set of (subject, status,
    incarnation) cells — the incremental cache-update path."""
    width = record_width(universe, max_digits)
    addr_pad, addr_len = _universe_tables(universe, width, subject.device)
    subj = subject.to(torch.int64).clamp(0, universe.n - 1)
    return _records_core(
        addr_pad[subj], addr_len[subj], status, inc_ms, present, max_digits, width
    )


def pack_record_words(rec_bytes: torch.Tensor) -> torch.Tensor:
    """[..., R] uint8 -> [..., ceil(R/4)] little-endian words (int32 view
    of uint32): a reinterpreting view when ``R`` is a multiple of 4."""
    if sys.byteorder != "little":
        raise RuntimeError("pack_record_words assumes a little-endian host")
    pad = (-rec_bytes.shape[-1]) % 4
    if pad:
        rec_bytes = torch.nn.functional.pad(rec_bytes, (0, pad))
    return u32.bytes_to_words(rec_bytes)


def _row_bytes_at(
    rec_words: torch.Tensor,  # [B, N, RW] int32
    seg_len: torch.Tensor,  # [B, N] int32
    ends: torch.Tensor,  # [B, N] int32 inclusive cumsum of seg_len
    pos: torch.Tensor,  # [B, P] int32 stream byte positions
    total: torch.Tensor,  # [B] int32 string length (sans trailing ';')
) -> torch.Tensor:
    """Gather individual assembled-string bytes without assembling the
    string: position -> owning member (binary search over the segment-end
    cumsum) -> byte within that member's record words."""
    B, n, rw = rec_words.shape
    m = torch.searchsorted(ends, pos.contiguous(), right=True)
    mc = m.clamp(0, n - 1)
    off = torch.gather(ends, 1, mc) - torch.gather(seg_len, 1, mc)
    local = pos - off
    wi = local.clamp(0, 4 * rw - 1) >> 2
    sh = (local & 3) << 3
    word = torch.gather(rec_words.reshape(B, n * rw), 1, mc * rw + wi.to(torch.int64))
    byte = (word >> sh) & 0xFF
    valid = (pos >= 0) & (pos < total[:, None])
    return torch.where(valid, byte, torch.zeros_like(byte)).to(torch.uint8)


def _le32(win: torch.Tensor, i: int) -> torch.Tensor:
    """Little-endian uint32 at static byte offset ``i`` of a [B, W] window."""
    b = win[:, i : i + 4].to(torch.int32)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def fused_hash_rows(
    rec_words: torch.Tensor,  # [B, N, RW] int32 (uint32 words)
    rec_len: torch.Tensor,  # [B, N] int32 (0 = absent member)
    impl: Optional[str] = None,  # "kernel" | "plain" | None = by device
) -> torch.Tensor:
    """FarmHash32 of each row's membership checksum string, computed from
    per-member record words without materializing the string.

    Returns ``[B]`` int32 (uint32 bit patterns)."""
    dev = rec_words.device
    seg = rec_len.to(torch.int32).contiguous()
    ends = torch.cumsum(seg, dim=1, dtype=torch.int32)
    total = (ends[:, -1] - 1).clamp(min=0)  # no trailing ';'
    B = rec_words.shape[0]

    # head window: the complete string for every short-bucket row (<= 24
    # bytes + 4 bytes fetch slack)
    head_pos = torch.arange(28, dtype=torch.int32, device=dev).expand(B, 28)
    head = _row_bytes_at(rec_words, seg, ends, head_pos, total)
    # tail window: the last 24 bytes, feeding the long-path tail mixes
    tail_pos = total[:, None] - 24 + torch.arange(24, dtype=torch.int32, device=dev)
    tail = _row_bytes_at(rec_words, seg, ends, tail_pos, total)

    # ---- long path (total > 24): init carries + tail mixes ------------
    n32 = total
    h0 = n32
    g0 = fh.C1 * n32
    f0 = g0

    def tw(off_from_end: int) -> torch.Tensor:
        v = _le32(tail, 24 - off_from_end)
        return fh._rot(v * fh.C1, 17) * fh.C2

    a0, a1, a2, a3, a4 = tw(4), tw(8), tw(16), tw(12), tw(20)
    h0 = h0 ^ a0
    h0 = fh._rot(h0, 19) * fh.FIVE + fh.MAGIC
    h0 = h0 ^ a2
    h0 = fh._rot(h0, 19) * fh.FIVE + fh.MAGIC
    g0 = g0 ^ a1
    g0 = fh._rot(g0, 19) * fh.FIVE + fh.MAGIC
    g0 = g0 ^ a3
    g0 = fh._rot(g0, 19) * fh.FIVE + fh.MAGIC
    f0 = f0 + a4
    f0 = fh._rot(f0, 19) + 113

    total_blocks = torch.where(
        total > 24, torch.div(total - 1, 20, rounding_mode="floor"), 0
    ).to(torch.int32)

    words = rec_words.contiguous()
    lens = rec_len.to(torch.int32).contiguous()
    if impl == "plain":
        h, g, f = stream_hash.fused_stream_plain(h0, g0, f0, words, lens, total_blocks)
    elif impl in (None, "kernel"):
        h, g, f = stream_hash.fused_stream(
            h0.contiguous(), g0.contiguous(), f0.contiguous(), words, lens, total_blocks
        )
    else:
        raise ValueError("unknown fused_hash_rows impl %r" % (impl,))

    g = fh._rot(g, 11) * fh.C1
    g = fh._rot(g, 17) * fh.C1
    f = fh._rot(f, 11) * fh.C1
    f = fh._rot(f, 17) * fh.C1
    h = fh._rot(h + g, 19)
    h = h * fh.FIVE + fh.MAGIC
    h = fh._rot(h, 17) * fh.C1
    h = fh._rot(h + f, 19)
    h = h * fh.FIVE + fh.MAGIC
    long_out = fh._rot(h, 17) * fh.C1

    out = fh._hash_0_4(head, total)
    out = torch.where(total > 4, fh._hash_5_12(head, total), out)
    out = torch.where(total > 12, fh._hash_13_24(head, total), out)
    return torch.where(total > 24, long_out, out)

