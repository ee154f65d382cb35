"""The scalable engine's record hash and ring digest, written for the
benchmark from their stated definitions (nothing of the program's code).

``record_mix(s, t, c)``: x = s * 0x9E3779B1 ^ t * 0x85EBCA77 ^ lo(c) *
0xC2B2AE3D ^ hi(c) * 0x27D4EB2F, then x ^= x >> 15, x *= 0x2C1B3C6D,
x ^= x >> 13, all mod 2^32 (``lo`` / ``hi``: the low and high 32-bit words
of ``c`` when it is a 64-bit value; a 32-bit ``c`` has no high word).  A
node's membership checksum is the sum mod 2^32 of the record hashes
``(node, status, incarnation stamp)`` of the view it holds.

The ring: node ``j`` owns ``replica_points`` points, point ``p`` at hash
``record_mix(j, p, 0x5EED)``; the ring is the points of the nodes in it
ordered by (hash, owner), unsigned, then one empty point (hash and owner
all ones) for each point of a node outside it.  Its digest is the sum mod
2^32 over positions ``q`` of ``record_mix(q, owner, hash)``.

Values are int64 tensors holding 32-bit words; products are taken in
16-bit halves so nothing overflows.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def record_mix(subject, status, inc) -> torch.Tensor:
    """Elementwise over broadcastable integer tensors; int64 result in
    [0, 2^32)."""
    inc = torch.as_tensor(inc)
    wide = inc.dtype == torch.int64
    subject, status, inc = (torch.as_tensor(v).to(torch.int64) for v in (subject, status, inc))
    x = _mul(subject & M32, 0x9E3779B1)
    x = x ^ _mul(status & M32, 0x85EBCA77)
    x = x ^ _mul(inc & M32, 0xC2B2AE3D)
    if wide:
        x = x ^ _mul((inc >> 32) & M32, 0x27D4EB2F)
    x = x ^ (x >> 15)
    x = _mul(x, 0x2C1B3C6D)
    return x ^ (x >> 13)


def truth_sum(status: torch.Tensor, inc: torch.Tensor) -> int:
    """The checksum of the view that holds every node at ``status`` /
    ``inc`` ([N] each)."""
    ids = torch.arange(status.shape[0], device=status.device)
    return int(record_mix(ids, status, inc).sum() & M32)


def ring_digest(in_ring: torch.Tensor, replica_points: int, block: int = 1 << 22) -> int:
    """The digest of the ring of the nodes ``in_ring`` ([N] bool)."""
    dev = in_ring.device
    n = in_ring.shape[0]
    owner = torch.arange(n, device=dev).repeat_interleave(replica_points)
    point = torch.arange(replica_points, device=dev).repeat(n)
    h = record_mix(owner, point, 0x5EED)
    keep = in_ring.repeat_interleave(replica_points)
    owner, h = owner[keep], h[keep]
    # by owner already; a stable sort by hash gives (hash, owner) order
    order = torch.sort(h, stable=True).indices
    owner, h = owner[order], h[order]
    empty = n * replica_points - owner.shape[0]
    owner = torch.cat([owner, torch.full((empty,), M32, dtype=torch.int64, device=dev)])
    h = torch.cat([h, torch.full((empty,), M32, dtype=torch.int64, device=dev)])
    total = 0
    for q0 in range(0, owner.shape[0], block):
        q = torch.arange(q0, min(owner.shape[0], q0 + block), device=dev)
        total += int(record_mix(q, owner[q0:q0 + q.shape[0]], h[q0:q0 + q.shape[0]]).sum())
    return total & M32
