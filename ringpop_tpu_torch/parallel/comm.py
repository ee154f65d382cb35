"""Collectives of the in-process shard mesh, and its lockstep loop.

A shard body (``engine_scalable.shard_tick``, ``engine.shard_tick``, the
exchange plane) is a generator that yields each collective as ``(op,
payload)``: the counterpart of the ``jax.lax`` collectives the JAX
package's shard_map body calls (``all_gather(tiled=True)``,
``all_to_all``, ``psum``, ``pmax``, ...), of the global predicate a
``lax.cond`` takes, and of the collectives GSPMD infers for the full
engine's gathers along the node axis and segment reductions onto it: the
row fetch by global index and the reduce-scatter.
:func:`lockstep` advances S bodies to their next collective, checks that
they all ask for the same one, and answers each with its share of the
combined value (:class:`MeshComm`).  One controller drives every shard, as
one Python process drives every device of a JAX mesh; a failure in any
body raises in the caller at once, and no shard is ever left waiting.

Combines run in shard order on each receiving device.  Integer combines
are exact in any order; the one float combine (``mean``) follows JAX's
partitioned mean (``engine_scalable.sharded_mean_f32``).  A tensor bound
for another device is a peer copy (``.to(dev, non_blocking=True)``);
shards that share a device share one combined tensor, which no body
writes in place.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import torch

from ringpop_tpu_torch.models.sim.engine_scalable import host_read, sharded_mean_f32
from ringpop_tpu_torch.obs import perf


def lockstep(bodies: Sequence, comm: "MeshComm") -> List:
    """Run S shard bodies to their ends in lockstep; returns each body's
    return value, in shard order.  Raises if the bodies ask for different
    collectives or do not all end together.  Under a span log each body's
    spans are logged as its shard's (``DispatchTimer.body``); a combine's
    host read is logged in shard 0's span of the site."""
    log = perf.active()
    outer = None if log is None else log.body
    replies = [None] * len(bodies)
    try:
        while True:
            reqs, ended = [], 0
            for shard, (body, reply) in enumerate(zip(bodies, replies)):
                if log is not None:
                    log.body = shard
                try:
                    reqs.append(body.send(reply))
                except StopIteration as stop:
                    reqs.append(("end", stop.value))
                    ended += 1
            ops = [r[0] for r in reqs]
            if ended:
                if ended != len(bodies):
                    raise RuntimeError("shards left the lockstep apart: %s" % (ops,))
                return [r[1] for r in reqs]
            if any(op != ops[0] for op in ops):
                raise RuntimeError("shards out of lockstep: %s" % (ops,))
            if log is not None:
                log.body = 0
            replies = comm.combine(ops[0], [r[1] for r in reqs])
    finally:
        if log is not None:
            log.body = outer


class MeshComm:
    """The collectives over an ordered list of shard devices.  ``calls``
    counts each op answered; ``a2a_bytes``, ``gather_bytes``,
    ``fetch_bytes`` and ``scatter_bytes`` the bytes that the all-to-alls,
    the all-gathers, the row fetches and the reduce-scatters moved between
    shards (a shard's own block excluded)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        self.calls: Counter = Counter()
        self.a2a_bytes = 0
        self.gather_bytes = 0
        self.fetch_bytes = 0
        self.scatter_bytes = 0

    def combine(self, op: str, parts: List[torch.Tensor]) -> List:
        self.calls[op] += 1
        return getattr(self, "_" + op)(parts)

    # -- helpers ---------------------------------------------------------

    def _per_device(self, make) -> List:
        """``make(dev)`` once per distinct device, one result per shard."""
        made = {}
        return [made[d] if d in made else made.setdefault(d, make(d)) for d in self.devices]

    def _reduce(self, parts, fn) -> List:
        if len(parts) == 1:
            return list(parts)
        if isinstance(parts[0], tuple):  # elementwise over a tuple of tensors
            each = [self._reduce(list(x), fn) for x in zip(*parts)]
            return [tuple(r[s] for r in each) for s in range(len(parts))]

        def make(dev):
            acc = parts[0].to(dev, non_blocking=True)
            for p in parts[1:]:
                acc = fn(acc, p.to(dev, non_blocking=True))
            return acc

        return self._per_device(make)

    # -- the collectives -------------------------------------------------

    def _gather(self, parts):
        """All-gather, tiled along dim 0."""
        if len(parts) == 1:
            return list(parts)
        self.gather_bytes += sum(p.numel() * p.element_size() for p in parts) * (len(parts) - 1)
        return self._per_device(lambda dev: torch.cat([p.to(dev, non_blocking=True) for p in parts]))

    def _all_to_all(self, parts):
        """``[S, ...]`` buffers: shard d receives block ``[s][d]`` of every
        shard s, stacked in shard order."""
        s = len(parts)
        if s == 1:
            return list(parts)
        self.a2a_bytes += sum(parts[i][j].numel() * parts[i][j].element_size()
                              for i in range(s) for j in range(s) if i != j)
        return [torch.stack([parts[i][d].to(dev, non_blocking=True) for i in range(s)])
                for d, dev in enumerate(self.devices)]

    def _sum(self, parts):
        return self._reduce(parts, torch.add)

    def _any(self, parts):
        return self._reduce(parts, torch.logical_or)

    def _all(self, parts):
        return self._reduce(parts, torch.logical_and)

    def _min(self, parts):
        return self._reduce(parts, torch.minimum)

    def _max(self, parts):
        return self._reduce(parts, torch.maximum)

    def _pred(self, parts):
        """The agreed predicate: any shard's, read on the host once."""
        value = host_read(self._any(parts)[0])
        return [value] * len(parts)

    def _counts(self, parts):
        """Every shard's [] count, in shard order, read on the host once."""
        host_read.count += 1
        dev = self.devices[0]
        counts = [int(c) for c in torch.stack([p.to(dev) for p in parts]).tolist()]
        return [counts] * len(parts)

    def _fetch(self, parts):
        """Rows by global index: shard d asks with ``(idx, planes)`` — its
        ``[M]`` global row ids and its own ``[L, ...]`` block of each
        node-leading plane (shard s holds rows ``[s*L, (s+1)*L)``) — and
        receives ``[M, ...]`` rows of every plane from their owners.  Each
        owner answers from its own block; no plane is gathered whole."""
        if len(parts) == 1:
            idx, planes = parts[0]
            return [[p[idx] for p in planes]]
        local = parts[0][1][0].shape[0]
        out = []
        for d, (idx, _) in enumerate(parts):
            dev = self.devices[d]
            owner = torch.div(idx, local, rounding_mode="floor")
            got = [None] * len(parts[0][1])
            for s, (_, planes) in enumerate(parts):
                at = (idx.to(self.devices[s], non_blocking=True) - s * local).clamp(0, local - 1)
                mine = owner == s
                for j, plane in enumerate(planes):
                    block = plane.index_select(0, at)
                    if s != d:
                        self.fetch_bytes += block.numel() * block.element_size()
                    block = block.to(dev, non_blocking=True)
                    if got[j] is None:
                        got[j] = block
                    else:
                        keep = mine.reshape(mine.shape + (1,) * (block.dim() - 1))
                        got[j] = torch.where(keep, block, got[j])
            out.append(got)
        return out

    def _scatter(self, parts, fn):
        """Reduce-scatter: each shard's ``[N, ...]`` partial, combined in
        shard order; shard d receives rows ``[d*L, (d+1)*L)`` of the result."""
        if len(parts) == 1:
            return list(parts)
        local = parts[0].shape[0] // len(parts)
        out = []
        for d, dev in enumerate(self.devices):
            rows = slice(d * local, (d + 1) * local)
            acc = parts[0][rows].to(dev, non_blocking=True)
            for p in parts[1:]:
                acc = fn(acc, p[rows].to(dev, non_blocking=True))
            self.scatter_bytes += sum(p[rows].numel() * p.element_size()
                                      for s, p in enumerate(parts) if s != d)
            out.append(acc)
        return out

    def _rs_max(self, parts):
        return self._scatter(parts, torch.maximum)

    def _rs_min(self, parts):
        return self._scatter(parts, torch.minimum)

    def _rs_any(self, parts):
        return self._scatter(parts, torch.logical_or)

    def _rs_sum(self, parts):
        return self._scatter(parts, torch.add)

    def _mean(self, parts):
        """The float32 mean of the shards' pieces, in JAX's order."""
        m = sharded_mean_f32(parts)
        return self._per_device(lambda dev: m.to(dev, non_blocking=True))
