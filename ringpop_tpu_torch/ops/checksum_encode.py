"""Checksum-string encoding over a static address universe.

Counterpart of ``ringpop_tpu/ops/checksum_encode.py``: the sorted address
:class:`Universe`, the ``STATUS_*`` wire tables, the decimal digit helpers,
and the row encoders :func:`membership_rows` and :func:`ring_rows`, which
build each row's checksum string into a padded ``[B, W] uint8`` buffer for
:func:`ringpop_tpu_torch.ops.farmhash.hash32_rows`.  The reference's
membership checksum is FarmHash32 of ``addr+status+incarnation`` joined
with ';' over members sorted by address (lib/membership/index.js:100-123);
the ring checksum joins the sorted server names (lib/ring/index.js:96-105).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

STATUS_ALIVE = 0
STATUS_SUSPECT = 1
STATUS_FAULTY = 2
STATUS_LEAVE = 3

STATUS_STRINGS = ("alive", "suspect", "faulty", "leave")
_STATUS_W = 7  # len("suspect")

STATUS_BYTES = np.zeros((4, _STATUS_W), dtype=np.uint8)
STATUS_LEN = np.zeros(4, dtype=np.int32)
for _i, _s in enumerate(STATUS_STRINGS):
    STATUS_BYTES[_i, : len(_s)] = np.frombuffer(_s.encode(), dtype=np.uint8)
    STATUS_LEN[_i] = len(_s)

MAX_DIGITS = 19  # int64 decimal digits
_POW10 = np.array([10**k for k in range(MAX_DIGITS)], dtype=np.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class Universe:
    """Static, lexicographically sorted address universe of a simulation.

    ``addresses[i]`` is node i's identity; every tensor indexed by node uses
    this order, which equals checksum-string member order (the reference's
    sort over ASCII host:port strings is bytewise)."""

    addresses: tuple
    addr_bytes: np.ndarray  # [N, A] uint8, zero-padded
    addr_len: np.ndarray  # [N] int32

    def __eq__(self, other):
        return isinstance(other, Universe) and self.addresses == other.addresses

    def __hash__(self):
        return hash(self.addresses)

    @staticmethod
    def from_addresses(addresses: Sequence[str]) -> "Universe":
        ordered = sorted(addresses)
        if len(set(ordered)) != len(ordered):
            raise ValueError("duplicate addresses in universe")
        encoded = [a.encode("utf-8") for a in ordered]
        width = max((len(e) for e in encoded), default=1)
        mat = np.zeros((len(encoded), width), dtype=np.uint8)
        lens = np.zeros(len(encoded), dtype=np.int32)
        for i, e in enumerate(encoded):
            mat[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
            lens[i] = len(e)
        return Universe(tuple(ordered), mat, lens)

    @property
    def n(self) -> int:
        return len(self.addresses)

    @property
    def addr_width(self) -> int:
        return self.addr_bytes.shape[1]

    def index_of(self, address: str) -> int:
        return self.addresses.index(address)

    def member_row_width(self, max_digits: int = MAX_DIGITS) -> int:
        """Static buffer width for a full-membership checksum string."""
        return int(self.addr_len.sum()) + self.n * (_STATUS_W + max_digits + 1) + 4

    def ring_row_width(self) -> int:
        return int(self.addr_len.sum()) + self.n + 4


def _ndigits(x: torch.Tensor) -> torch.Tensor:
    """Decimal digit count of non-negative int64 (0 -> 1 digit)."""
    x = x.to(torch.int64)
    count = torch.ones(x.shape, dtype=torch.int32, device=x.device)
    for k in range(1, MAX_DIGITS):
        count = count + (x >= int(_POW10[k])).to(torch.int32)
    return count


_POW10_TABLES: dict = {}


def _pow10_table(device) -> torch.Tensor:
    """:data:`_POW10` on ``device``, uploaded once per device (an upload
    inside a tick is a synchronous copy on the card)."""
    got = _POW10_TABLES.get(device)
    if got is None:
        got = _POW10_TABLES[device] = torch.as_tensor(_POW10, device=device)
    return got


def _digit_bytes(x: torch.Tensor, dlen: torch.Tensor, max_digits: int) -> torch.Tensor:
    """[..., max_digits] ASCII digits of x, most significant first, left-
    aligned within dlen (positions >= dlen are garbage, masked by caller)."""
    x = x.to(torch.int64)
    k = torch.arange(max_digits, dtype=torch.int32, device=x.device)
    exp = (dlen[..., None] - 1 - k).clamp(0, MAX_DIGITS - 1)
    pow10 = _pow10_table(x.device)[exp.long()]
    digit = torch.div(x[..., None], pow10, rounding_mode="floor") % 10
    return (digit + ord("0")).to(torch.uint8)


def _tables(universe: Universe, device):
    """(addr_bytes [N, A] uint8, addr_len [N] int32, status_bytes [4, 7]
    uint8, status_len [4] int32) on ``device``, built once per device."""
    cache = universe.__dict__.setdefault("_encode_tables", {})
    key = str(device)
    got = cache.get(key)
    if got is None:
        got = (
            torch.as_tensor(universe.addr_bytes, device=device),
            torch.as_tensor(universe.addr_len, device=device),
            torch.as_tensor(STATUS_BYTES, device=device),
            torch.as_tensor(STATUS_LEN, device=device),
        )
        cache[key] = got
    return got


def _scatter_rows(
    width: int,
    positions: torch.Tensor,  # [C, M] target position per byte, >= width drops
    values: torch.Tensor,  # [C, M] uint8
    unique: bool = False,
) -> torch.Tensor:
    """Scatter each row's bytes into a zeroed ``[C, width]`` buffer,
    dropping positions at or past ``width``.  Live positions of a row are
    disjoint by construction (member segments never overlap).  ``unique``
    also sends every dropped byte to a slot of its own, so no two writes
    share an index (JAX's ``unique_indices`` promise); otherwise a row's
    dropped bytes share one sentinel slot."""
    C, M = positions.shape
    dev = positions.device
    pos = positions.to(torch.int64)
    row = torch.arange(C, dtype=torch.int64, device=dev)[:, None]
    if unique:
        sink = C * width + row * M + torch.arange(M, dtype=torch.int64, device=dev)[None, :]
        size = C * width + C * M
    else:
        sink = C * width + row
        size = C * width + C
    idx = torch.where(pos < width, row * width + pos, sink)
    buf = torch.zeros(size, dtype=torch.uint8, device=dev)
    buf = buf.index_put((idx.reshape(-1),), values.reshape(-1).to(torch.uint8))
    return buf[: C * width].reshape(C, width)


def membership_rows(
    universe: Universe,
    present: torch.Tensor,  # [B, N] bool
    status: torch.Tensor,  # [B, N] int codes
    incarnation: torch.Tensor,  # [B, N] int64
    max_digits: int = MAX_DIGITS,
    width: Optional[int] = None,
    chunk: int = 64,
    impl: str = "scatter_unique",
):
    """Build per-row membership checksum strings; returns ``(buf [B, W]
    uint8, lens [B] int32)``, ready for ``farmhash.hash32_rows``.

    ``max_digits`` bounds the incarnation's decimal digits (a wider value
    would silently corrupt the string).  ``impl``: "scatter_unique" (the
    default) or "scatter" — each member segment's bytes scattered to its
    cumsum offset (see :func:`_scatter_rows`); "gather" or "gather2" —
    each output byte gathered from the member that owns it
    (:func:`_membership_rows_gather`).  All four give the same first
    ``lens`` bytes of every row; past them the scatter forms keep the
    final separator and the gather forms zeros."""
    if impl in ("gather", "gather2"):
        return _membership_rows_gather(
            universe, present, status, incarnation, max_digits, width, chunk,
            member_of="cumsum" if impl == "gather2" else "searchsorted",
        )
    if impl not in ("scatter_unique", "scatter"):
        raise ValueError("membership_rows impl must be scatter_unique|scatter|gather|gather2, "
                         "got %r" % (impl,))
    unique = impl == "scatter_unique"
    width = width or universe.member_row_width(max_digits)
    A = universe.addr_width
    n = universe.n
    dev = present.device
    addr_bytes, addr_len, status_bytes, status_len = _tables(universe, dev)
    ka = torch.arange(A, dtype=torch.int32, device=dev)
    ks = torch.arange(_STATUS_W, dtype=torch.int32, device=dev)
    kd = torch.arange(max_digits, dtype=torch.int32, device=dev)

    def rows(pres, stat, inc):
        C = pres.shape[0]
        stat = stat.to(torch.int64)
        pres_i = pres.to(torch.int32)
        slen = status_len[stat]
        dlen = _ndigits(inc)
        seg_len = (addr_len + slen + dlen + 1) * pres_i
        offset = torch.cumsum(seg_len, dim=1, dtype=torch.int32) - seg_len
        total = (seg_len.sum(dim=1, dtype=torch.int32) - 1).clamp(min=0) * (
            pres_i.sum(dim=1, dtype=torch.int64) > 0
        ).to(torch.int32)
        drop = width
        p3 = pres[:, :, None]

        pos_a = offset[:, :, None] + ka
        pos_a = torch.where(p3 & (ka < addr_len[:, None]), pos_a, drop)
        s_base = offset + addr_len
        pos_s = s_base[:, :, None] + ks
        pos_s = torch.where(p3 & (ks < slen[:, :, None]), pos_s, drop)
        val_s = status_bytes[stat]
        d_base = s_base + slen
        pos_d = d_base[:, :, None] + kd
        pos_d = torch.where(p3 & (kd < dlen[:, :, None]), pos_d, drop)
        val_d = _digit_bytes(inc, dlen, max_digits)
        pos_sep = torch.where(p3, (d_base + dlen)[:, :, None], drop)
        val_sep = torch.full((C, n, 1), ord(";"), dtype=torch.uint8, device=dev)

        positions = torch.cat([pos_a, pos_s, pos_d, pos_sep], dim=2)
        values = torch.cat([addr_bytes.expand(C, n, A), val_s, val_d, val_sep], dim=2)
        return _scatter_rows(width, positions.reshape(C, -1), values.reshape(C, -1), unique), total

    return _chunked_rows(rows, present, status, incarnation, chunk)


def _membership_rows_gather(
    universe: Universe,
    present: torch.Tensor,  # [B, N] bool
    status: torch.Tensor,  # [B, N] int codes
    incarnation: torch.Tensor,  # [B, N] int64
    max_digits: int = MAX_DIGITS,
    width: Optional[int] = None,
    chunk: int = 64,
    member_of: str = "searchsorted",
):
    """Gather-form encoder: output byte b of a row belongs to the member
    whose ``[offset, offset + seg_len)`` interval holds b, and is that
    member's address byte, status byte, incarnation digit or ';' by its
    position within the segment; bytes from ``total`` on are zero.  No
    byte-level scatter.  ``member_of`` picks how byte -> member is found:
    "searchsorted" (a binary search over the segment-end cumsum) or
    "cumsum" (a 1 at each present member's start, a prefix sum over the
    row width, and the rank mapped back through the present members) —
    both give the last present member whose offset is at most b."""
    width = width or universe.member_row_width(max_digits)
    A = universe.addr_width
    n = universe.n
    dev = present.device
    i32, i64 = torch.int32, torch.int64
    addr_bytes, addr_len, status_bytes, status_len = _tables(universe, dev)
    b_pos = torch.arange(width, dtype=i32, device=dev)
    members = torch.arange(n, dtype=i32, device=dev)

    def rows(pres, stat, inc):
        C = pres.shape[0]
        stat = stat.to(i64)
        pres_i = pres.to(i32)
        slen = status_len[stat]
        dlen = _ndigits(inc)
        seg_len = (addr_len + slen + dlen + 1) * pres_i
        ends = torch.cumsum(seg_len, dim=1, dtype=i32)
        offset = ends - seg_len
        total = (ends[:, -1] - 1).clamp(min=0) * (pres_i.sum(dim=1, dtype=torch.int64) > 0).to(i32)
        if member_of == "cumsum":
            starts = torch.zeros((C, width + 1), dtype=i32, device=dev).scatter_add_(
                1, offset.clamp(0, width).to(i64), pres_i)
            rank_of_byte = torch.cumsum(starts[:, :width], dim=1, dtype=i32) - 1
            prank = torch.cumsum(pres_i, dim=1, dtype=i32) - 1
            # column n takes the absent members (JAX's dropped writes)
            rank_to_m = torch.zeros((C, n + 1), dtype=i32, device=dev).scatter_(
                1, torch.where(pres, prank, n).to(i64), members.expand(C, n))[:, :n]
            mc = torch.gather(rank_to_m, 1, rank_of_byte.clamp(0, n - 1).to(i64)).to(i64)
        else:
            mc = torch.searchsorted(ends, b_pos.expand(C, width).contiguous(), right=True)
            mc = mc.clamp(0, n - 1)
        local = b_pos - torch.gather(offset, 1, mc)
        al = addr_len[mc]
        sl = torch.gather(slen, 1, mc)
        dl = torch.gather(dlen, 1, mc)
        s_off = local - al
        d_off = s_off - sl
        byte_addr = addr_bytes[mc, local.clamp(0, A - 1).to(i64)]
        byte_status = status_bytes[torch.gather(stat, 1, mc), s_off.clamp(0, _STATUS_W - 1).to(i64)]
        # a per-member digit table ([N, D] divisions), not one per byte
        val_d = _digit_bytes(inc, dlen, max_digits).reshape(C, n * max_digits)
        byte_digit = torch.gather(val_d, 1, mc * max_digits + d_off.clamp(0, max_digits - 1))
        sep = torch.full_like(byte_addr, ord(";"))
        out = torch.where(
            local < al,
            byte_addr,
            torch.where(
                (s_off >= 0) & (s_off < sl),
                byte_status,
                torch.where((d_off >= 0) & (d_off < dl), byte_digit, sep),
            ),
        )
        out = torch.where(b_pos < total[:, None], out, torch.zeros_like(out))
        return out, total

    return _chunked_rows(rows, present, status, incarnation, chunk)


def _chunked_rows(rows, present, status, incarnation, chunk):
    """Run the batched row encoder ``rows`` over ``chunk``-row slabs, which
    bounds its ``[chunk, N, S]`` intermediates."""
    B = present.shape[0]
    if B <= chunk:
        return rows(present, status, incarnation)
    bufs, lens = [], []
    for lo in range(0, B, chunk):
        b, l = rows(present[lo:lo + chunk], status[lo:lo + chunk], incarnation[lo:lo + chunk])
        bufs.append(b)
        lens.append(l)
    return torch.cat(bufs), torch.cat(lens)


def ring_rows(
    universe: Universe,
    in_ring: torch.Tensor,  # [B, N] bool: the servers in each row's ring
    width: Optional[int] = None,
):
    """Build per-row ring checksum strings (sorted names joined with ';');
    returns ``(buf [B, W] uint8, lens [B] int32)``."""
    width = width or universe.ring_row_width()
    A = universe.addr_width
    n = universe.n
    dev = in_ring.device
    addr_bytes, addr_len, _, _ = _tables(universe, dev)
    C = in_ring.shape[0]
    pres_i = in_ring.to(torch.int32)
    seg_len = (addr_len + 1) * pres_i
    offset = torch.cumsum(seg_len, dim=1, dtype=torch.int32) - seg_len
    total = (seg_len.sum(dim=1, dtype=torch.int32) - 1).clamp(min=0) * (
        pres_i.sum(dim=1, dtype=torch.int64) > 0
    ).to(torch.int32)
    drop = width
    p3 = in_ring[:, :, None]
    ka = torch.arange(A, dtype=torch.int32, device=dev)
    pos_a = torch.where(p3 & (ka < addr_len[:, None]), offset[:, :, None] + ka, drop)
    pos_sep = torch.where(p3, (offset + addr_len)[:, :, None], drop)
    val_sep = torch.full((C, n, 1), ord(";"), dtype=torch.uint8, device=dev)
    positions = torch.cat([pos_a, pos_sep], dim=2)
    values = torch.cat([addr_bytes.expand(C, n, A), val_sep], dim=2)
    return _scatter_rows(width, positions.reshape(C, -1), values.reshape(C, -1)), total
