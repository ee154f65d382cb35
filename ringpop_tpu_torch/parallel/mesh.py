"""Both simulation engines over an in-process shard mesh.

Counterpart of ``ringpop_tpu/parallel/mesh.py`` (``make_mesh``,
``make_mesh_2d``, ``ShardedSim``, ``_route_rows_stats``,
``make_exchange_plane``, ``ShardedStorm``).  The N-node axis is split over
S shards, each a ``torch.device``: shard s holds rows ``[s*N/S,
(s+1)*N/S)`` of every node-indexed field (for the full engine, the
observer rows of every ``[N, N]`` plane) and a copy of what is not
node-indexed (the clock; the scalable engine's bounded rumor table and
rng).  One process drives every shard, as one Python process drives every
device of a JAX mesh: each tick runs S shard bodies (``engine.shard_tick``
or ``engine_scalable.shard_tick``) in lockstep (``comm.lockstep``), and
every read of another shard's rows is an explicit collective.

``ShardedSim`` is the full-fidelity engine on the mesh.  JAX compiles its
tick as one GSPMD program, where a ``pallas_call`` does not partition, so
JAX drops the fused tick to its plain twin on a mesh.  Every kernel of the
tick (``apply_updates``, ``pb_budget``, ``fused_stream``, ``block_loop``)
works on whole rows, so here each shard launches the kernels on its own
rows; ``fused_tick_resolution()`` reports this pick beside JAX's.

- On one card the S shards share ``cuda:0``; on a machine with more cards
  they take ``cuda:0..`` round-robin; on the CPU they all sit on ``cpu``.
  :func:`make_mesh` never moves a shard off the device type it was asked
  for, and the devices a storm got are in ``exchange_resolution()``.
- The direct push-pull round is the exchange plane
  (:func:`make_exchange_plane`): the pull rows and the ``direct_ok``-masked
  push rows go to their receivers by one capped all-to-all each
  (:func:`_route_rows_stats`; an overflowing bucket, agreed across the
  shards, sends them by the all-gather route instead), and each shard then
  runs the exchange on its own ``[N/S, U/32]`` tile — with ``impl="kernel"``
  the CUDA kernel ``csrc/exchange.cu``, one launch a shard.
- The trajectory is bitwise the single-device ``ScalableCluster``'s and the
  JAX ``ShardedStorm``'s at the same shard count; ``mean_heard_frac``, the
  one float, is summed in the order of JAX's node-sharded mean
  (``engine_scalable.sharded_mean_f32``).

Every obs plane runs on the mesh, bitwise the single device's, as fields
of the sharded state that ``.state`` joins (as in JAX, neither driver has
a drain of its own; ``obs.events`` and ``obs.histograms`` read the joined
fields).  The full engine's ``first_heard`` is node-leading, its event
buffer sits in capacity blocks (``models/sim/flight.py``: ordered as the
single device's, placed by one gather of the shards' emission counts and
one of their candidate lanes) and its ``hist`` is whole on every shard;
the storm's ``first_heard`` [N, U] is split by node rows (the common
checkpoint file keeps it whole, as JAX's) and its ``hist`` is whole on
every shard; the exchange telemetry (``exchange_metrics = S``) keeps a
row a shard.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ringpop_tpu_torch import convert, resolve_device
from ringpop_tpu_torch.models.ring.device import build_ring, device_replica_hashes, ring_checksum
from ringpop_tpu_torch.models.sim import checkpoint as ckpt
from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.cluster import (
    _tick_at, default_addresses, fixup_sim_state, metrics_to_numpy,
)
from ringpop_tpu_torch.models.sim.recovery import CheckpointableMixin, CheckpointSpec, states_to
from ringpop_tpu_torch.models.sim.storm import fixup_scalable_state
from ringpop_tpu_torch.obs import exchange_stats as oxs
from ringpop_tpu_torch.ops import exchange as _exch
from ringpop_tpu_torch.ops import histogram as hg
from ringpop_tpu_torch.ops import checksum_encode as ce
from ringpop_tpu_torch.ops import toolkit, u32
from ringpop_tpu_torch.ops.exchange import exchange_cap
from ringpop_tpu_torch.parallel.comm import MeshComm, lockstep

AXIS = "nodes"


class Mesh:
    """Ordered shard devices and the axes the node dimension is split
    over, in order (``("nodes",)``, or ``("dcn", "ici")`` for a 2-D mesh:
    shard ``h * chips + c`` is host h's chip c).  ``shape`` maps each axis
    to its size; ``size`` is the shard count."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str], shape: Sequence[int]):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError("mesh shape %r does not hold %d devices"
                             % (tuple(shape), len(self.devices)))

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return "Mesh(%r, %r)" % (self.shape, [str(d) for d in self.devices])


def _shard_devices(count: int, device) -> List[torch.device]:
    """``count`` shard devices of ``device``'s type, round-robin over the
    visible cards; all ``cpu`` for the CPU.  Raises when the card is asked
    for and none is present."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * count
    if dev.index is not None:
        return [dev] * count
    cards = torch.cuda.device_count()
    return [torch.device("cuda", s % cards) for s in range(count)]


def make_mesh(n_shards: Optional[int] = None, devices: Optional[Sequence] = None,
              device="cuda", axis: str = AXIS) -> Mesh:
    """A 1-D mesh of ``n_shards`` shards (default: one a visible card, or
    one on the CPU) placed round-robin over the cards of ``device``'s type,
    or on the given ``devices``."""
    if devices is None:
        if n_shards is None:
            n_shards = torch.cuda.device_count() if resolve_device(device).type == "cuda" else 1
        devices = _shard_devices(n_shards, device)
    elif n_shards is not None:
        devices = list(devices)[:n_shards]
    return Mesh(devices, (axis,), (len(devices),))


def make_mesh_2d(n_hosts: int, chips_per_host: int, devices: Optional[Sequence] = None,
                 axes: Sequence[str] = ("dcn", "ici"), device="cuda") -> Mesh:
    """A 2-D (hosts x chips) mesh; the node dimension is split over both
    axes in order, as JAX's ``_node_axis`` does."""
    need = n_hosts * chips_per_host
    if devices is None:
        devices = _shard_devices(need, device)
    if len(devices) != need:
        raise ValueError("need exactly %d devices for a %dx%d mesh, have %d"
                         % (need, n_hosts, chips_per_host, len(devices)))
    return Mesh(devices, axes, (n_hosts, chips_per_host))


class Shard:
    """The context of one shard's body (the protocol of
    ``engine_scalable.Solo``): its index, the shard count, its first global
    row and row count, whether it holds only its own exchange-telemetry
    row, and its row route (capped at ``cap``)."""

    def __init__(self, index: int, shards: int, rows: int, cap: int, exch_rows: bool):
        self.index, self.shards, self.rows = index, shards, rows
        self.lo = index * rows
        self.cap = cap
        self.exch_rows = exch_rows

    def route_rows(self, rows, dest, src):
        return (yield from _route_rows(self, rows, dest, src, self.cap))


def _one_device_type(mesh: Mesh) -> str:
    device_type = mesh.devices[0].type
    if any(d.type != device_type for d in mesh.devices):
        raise ValueError("a mesh's shards share one device type, got %r" % (mesh,))
    return device_type


# ---------------------------------------------------------------------------
# ShardedSim


class ShardedSim(CheckpointableMixin):
    """``SimCluster`` over a shard mesh: the same ``bootstrap``/``step``/
    ``run`` surface, the observer rows of every ``[N, N]`` plane split over
    the mesh, and the trajectory bitwise the single-device engine's at any
    shard count.

    Each shard runs ``engine.shard_tick`` on its own rows, launching the
    tick's kernels there (``fused_tick_resolution()``); the bounded-parity
    overflow replay (``parity_replays``) is the single-device cluster's,
    decided on the whole cluster's counts.  With ``SimParams(flight_recorder=
    True)`` and ``histograms=True`` the planes are fields of the joined
    ``state``: ``obs.events.decode_events`` and ``obs.histograms.summarize``
    read them, and a drain is a reset of ``ev_head``/``ev_drops`` or
    ``hist`` through the ``state`` setter."""

    def __init__(self, n: int, mesh: Optional[Mesh] = None, params=None,
                 addresses: Optional[Sequence[str]] = None, seed: int = 0):
        self.mesh = mesh if mesh is not None else make_mesh()
        shards = self.mesh.size
        self.device = self.mesh.devices[0]
        device_type = _one_device_type(self.mesh)
        if addresses is None:
            addresses = default_addresses(n)
        self.universe = ce.Universe.from_addresses(addresses)
        n = self.universe.n
        params = params or engine.SimParams(n=n)
        if params.n != n:
            params = params._replace(n=n)
        if n % shards:
            raise ValueError("n=%d not divisible by mesh size %d" % (n, shards))
        requested = params.fused_tick
        params = params._replace(hash_impl=engine.resolve_hash_impl(params, device_type))
        self.params = engine.resolve_auto_parity(params, device_type)
        # the port's pick on the mesh is the single device's: each shard
        # launches the kernels on its own rows
        self._resolution_note = {
            "requested": requested,
            "impl": self.params.fused_tick,
            "jax_impl": engine.resolve_sharded_fused_tick(params, device_type),
            "single_device_resolution": self.params.fused_tick,
            "differs_from_single_device": False,
            "shards": shards,
            "devices": [str(d) for d in self.mesh.devices],
        }
        rows = n // shards
        self._shards = [Shard(s, shards, rows, 0, False) for s in range(shards)]
        self.comm = MeshComm(self.mesh.devices)
        self.state = engine.init_state(self.params, seed=seed, universe=self.universe,
                                       device=self.device)
        # bounded-parity overflow replays, like SimCluster's
        self.parity_replays = 0

    # -- the state ---------------------------------------------------------

    @property
    def shard_states(self) -> List[engine.SimState]:
        """The per-shard states (the real ones)."""
        return list(self._states)

    @property
    def state(self) -> engine.SimState:
        """The whole state, joined onto the first shard's device."""
        return convert.join_sim_state(self._states, self.device)

    @state.setter
    def state(self, state: engine.SimState) -> None:
        self._states = convert.split_sim_state(state, self.mesh.devices)

    def fused_tick_resolution(self) -> dict:
        """The mesh's fused-tick resolution: ``impl`` is the port's pick
        (the kernels, each shard on its own rows, wherever the single
        device picks them), ``jax_impl`` what JAX's ``ShardedSim`` runs in
        the port's terms (its table drops the kernels to the plain twin
        under GSPMD), with ``requested``, ``single_device_resolution``,
        ``differs_from_single_device``, ``shards`` and ``devices``."""
        note = dict(self._resolution_note)
        note["devices"] = list(note["devices"])
        return note

    def _shard_inputs(self, by_dev) -> List[engine.TickInputs]:
        """Each shard's node columns (the last axis) of ``by_dev[device]``,
        the whole-cluster inputs uploaded once to each of the mesh's devices."""
        return [engine.TickInputs(*(None if x is None else x[..., sh.lo:sh.lo + sh.rows]
                                    for x in by_dev[dev]))
                for sh, dev in zip(self._shards, self.mesh.devices)]

    def _tick(self, states, shard_inputs, params):
        bodies = [engine.shard_tick(sh, st, inp, params, self.universe)
                  for sh, st, inp in zip(self._shards, states, shard_inputs)]
        results = lockstep(bodies, self.comm)
        return [st for st, _ in results], results[0][1]  # whole-cluster metrics

    def _run_window(self, states, shard_inputs, ticks, params):
        rows = []
        for t in range(ticks):
            states, m = self._tick(states, [_tick_at(inp, t) for inp in shard_inputs], params)
            rows.append(m)
        return states, engine.TickMetrics(*(torch.stack(f) for f in zip(*rows)))

    # -- bounded-parity overflow fallback --------------------------------

    @property
    def _bounded_parity(self) -> bool:
        return self.params.checksum_mode == "farmhash" and self.params.parity_recompute == "bounded"

    def _exact_params(self) -> engine.SimParams:
        """The exact-recompute twin for overflow replays ("full" for fused
        runs, "gated" for unfused ones), as SimCluster's."""
        return self.params._replace(parity_recompute=engine.resolve_exact_recompute(self.params))

    def _maybe_replay_exact(self, pre, metrics, replay):
        """The bounded-parity overflow fallback shared by step/run: when the
        whole cluster overflowed the bounded chunk, discard the result and
        return ``replay(exact_params)`` from the pre-run states (None when
        nothing overflowed)."""
        if not self._bounded_parity or not int(metrics.parity_overflow.sum(dtype=torch.int64)):
            return None
        self.parity_replays += 1
        return replay(self._exact_params())

    # -- the surface of SimCluster ----------------------------------------

    def quiet_inputs(self) -> engine.TickInputs:
        return engine.TickInputs.quiet(self.params.n, self.device)

    def bootstrap(self) -> engine.TickMetrics:
        """Join every node at once."""
        return self.step(self.quiet_inputs()._replace(
            join=torch.ones(self.params.n, dtype=torch.bool, device=self.device)
        ))

    def step(self, inputs: Optional[engine.TickInputs] = None) -> engine.TickMetrics:
        """One tick; ``inputs`` are whole-cluster ``[N]`` planes (tensors or
        arrays).  Returns its metrics as numpy scalars."""
        if inputs is None:
            inputs = self.quiet_inputs()
        dtypes = (torch.bool, torch.bool, torch.bool, torch.int32, torch.bool, torch.bool)
        shard_inputs = self._shard_inputs(
            {dev: [None if x is None else torch.as_tensor(x, dtype=dt).to(dev)
                   for x, dt in zip(inputs, dtypes)]
             for dev in dict.fromkeys(self.mesh.devices)})
        pre = self._states
        states, metrics = self._tick(pre, shard_inputs, self.params)
        replayed = self._maybe_replay_exact(
            pre, metrics, lambda params: self._tick(pre, shard_inputs, params))
        self._states, metrics = (states, metrics) if replayed is None else replayed
        self._after_ticks(1)
        return metrics_to_numpy(metrics)

    def run(self, schedule) -> engine.TickMetrics:
        """Loop the tick over a dense ``EventSchedule``; returns ``[T]``
        numpy metrics (split at checkpoint-cadence lines when checkpoints
        are on, bitwise-neutrally)."""
        return self._run_chunked(schedule, self._run_schedule)

    def _run_schedule(self, schedule) -> engine.TickMetrics:
        shard_inputs = self._shard_inputs(
            {dev: schedule.as_inputs(dev) for dev in dict.fromkeys(self.mesh.devices)})
        pre = self._states
        states, metrics = self._run_window(pre, shard_inputs, schedule.ticks, self.params)
        replayed = self._maybe_replay_exact(
            pre, metrics,
            lambda params: self._run_window(pre, shard_inputs, schedule.ticks, params))
        self._states, metrics = (states, metrics) if replayed is None else replayed
        return metrics_to_numpy(metrics)

    def run_until_converged(self, max_ticks: int = 200, quiet_after: int = 0) -> int:
        """Tick until every live+ready node shares one checksum; returns the
        number of ticks taken (or -1 if not converged within max_ticks)."""
        for t in range(max_ticks):
            m = self.step()
            if t >= quiet_after and bool(m.converged):
                return t + 1
        return -1

    def checksums(self) -> np.ndarray:
        """[N] uint32 membership checksums."""
        return u32.to_numpy(torch.cat([st.checksum.to(self.device) for st in self._states]))

    # -- checkpoint/resume (models/sim/recovery.py) -------------------------
    # Every non-scalar field of the joined state is split across per-shard
    # files with np.array_split, one a mesh shard by default (JAX's
    # format); a restore reassembles them and splits them again under THIS
    # mesh, so a save resumes on any shard count, on SimCluster and in
    # either package.

    def _default_ckpt_shards(self) -> int:
        return self.mesh.size

    def _ckpt_sharded_fields(self) -> frozenset:
        return frozenset(f for f, x in zip(engine.SimState._fields, self._states[0])
                         if x is not None and x.dim() >= 1)

    def _ckpt_spec(self) -> CheckpointSpec:
        return CheckpointSpec(engine.SimState, self.params, self._ckpt_sharded_fields())

    def _ckpt_states(self):
        # joined onto one device: the save reads it to the host in one transfer
        return self.state

    def _ckpt_install(self, state) -> None:
        self.state = fixup_sim_state(states_to(state, self.device), self.params, self.universe)

    def save(self, path: str, shards: Optional[int] = None) -> None:
        """Manifest-format checkpoint directory at ``path``."""
        ckpt.save_checkpoint(
            path, self.state, self.params,
            shards=self._default_ckpt_shards() if shards is None else shards,
            sharded_fields=self._ckpt_sharded_fields(),
        )

    def load(self, path: str) -> None:
        """Resume from ``path`` — a legacy ``.npz`` file or a manifest
        checkpoint directory of any shard count, from either package."""
        self._ckpt_install(ckpt.load_any(path, engine.SimState, self.params))


# ---------------------------------------------------------------------------
# row routing and the exchange plane


def _route_rows_stats(sh, rows, dest_l, src_l, cap: int):
    """Deliver row ``g`` of the sharded ``rows`` to global row
    ``dest[g]`` (a shard body's generator): returns ``(routed, counts,
    overflow)`` — this shard's delivered rows (``rows[src]`` at its own
    rows, ``src`` the inverse of ``dest``), its ``[S]`` destination-bucket
    occupancy before capping, and the agreed fallback verdict as a [] bool.

    Fast path: bucket the local rows by destination shard, pad each bucket
    to the static ``cap``, one all-to-all for the row payloads and one for
    the ``[S, cap]`` destination positions, then scatter the received rows
    into place (a permutation: every local row written once).  A bucket
    fuller than ``cap`` on any shard — agreed across the shards and read on
    the host once, where JAX's ``lax.cond`` takes the global flag — sends
    the rows by the bit-identical all-gather route instead (``full[src]``)."""
    shards = sh.shards
    local, width = rows.shape
    dev = rows.device
    i32 = torch.int32
    dshard = torch.div(dest_l, local, rounding_mode="floor").to(i32)
    dpos = dest_l - dshard * local
    # [S, L]: row d marks the local rows bound for shard d (rows, not
    # columns: a scan along a 4-wide outer dim runs 4 threads on the card)
    hit = (dshard[None, :] == torch.arange(shards, dtype=i32, device=dev)[:, None]).to(i32)
    counts = hit.sum(dim=1, dtype=i32)
    overflow = yield ("pred", (counts > cap).any())
    if overflow:
        full = yield ("gather", rows)
        routed = full.index_select(0, src_l)
    else:
        # rank within the destination bucket: one flat scan over the rows
        # of `hit`, less the hits of the buckets before
        run = hit.reshape(-1).cumsum(0, dtype=i32).reshape(shards, local)
        before = counts.cumsum(0, dtype=i32) - counts
        d = dshard.long()
        slot = run.gather(0, d[None, :])[0] - before.index_select(0, d) - 1
        at = (d, slot.long())
        buf = torch.zeros((shards, cap, width), dtype=rows.dtype, device=dev).index_put_(at, rows)
        pos = torch.full((shards, cap), -1, dtype=i32, device=dev).index_put_(at, dpos)
        rbuf = yield ("all_to_all", buf)
        rpos = (yield ("all_to_all", pos)).reshape(-1)
        # the empty slots (-1) land in a dropped row ``local``
        out = torch.zeros((local + 1, width), dtype=rows.dtype, device=dev)
        out.index_copy_(0, torch.where(rpos >= 0, rpos, local).long(), rbuf.reshape(-1, width))
        routed = out[:local]
    return routed, counts, torch.full((), overflow, dtype=torch.bool, device=dev)


def _route_rows(sh, rows, dest_l, src_l, cap: int):
    """:func:`_route_rows_stats` without the statistics."""
    return (yield from _route_rows_stats(sh, rows, dest_l, src_l, cap))[0]


def make_exchange_plane(mesh: Mesh, impl: str, cap: Optional[int] = None,
                        n: Optional[int] = None, metrics: bool = False):
    """The direct-round exchange plane for the engine seam: a generator
    function ``plane(shard, heard, r_delta, active_words, direct_ok,
    partner0, inv_base) -> (new_heard, d_direct)`` run in each shard's body
    on its own rows.  It routes the pull rows (row ``p`` to
    ``inv_base[p]``) and the ``direct_ok``-masked push rows (row ``j`` to
    ``partner0[j]``) with :func:`_route_rows`, applies the receiver's
    ``direct_ok`` mask and the active-word mask in the inline path's
    order, and runs ``ops.exchange.exchange_local`` on the shard's tile
    (``impl`` "kernel": the CUDA kernel; "plain": its plain version).

    ``cap=None`` sizes the buckets with :func:`exchange_cap` (``n`` then
    required); an explicit cap is the overflow-fallback lever.
    ``metrics=True`` gives the telemetry flavour, which also takes and
    returns the shard's ``exch [1, C]`` and ``exch_hist [1, 2, NB]`` rows."""
    if impl not in ("kernel", "plain"):
        raise ValueError("plane impl must be kernel|plain, got %r" % (impl,))
    shards = mesh.size
    if cap is None:
        if n is None:
            raise ValueError("make_exchange_plane needs cap= or n=")
        if n % shards:
            raise ValueError("n=%d not divisible by %d shards" % (n, shards))
        cap = exchange_cap(n // shards, shards)

    def plane(sh, h_l, r_delta, active_words, ok_l, fwd_l, inv_l):
        # pull: row p -> inv[p]; the receiver gates on its own direct_ok
        pulled = yield from _route_rows(sh, h_l, inv_l, fwd_l, cap)
        pulled = torch.where(ok_l[:, None], pulled, 0) & active_words[None, :]
        # push: the sender gates on its own direct_ok; row j -> partner0[j]
        pushed = yield from _route_rows(sh, torch.where(ok_l[:, None], h_l, 0), fwd_l, inv_l, cap)
        pushed = pushed & active_words[None, :]
        return _exch.exchange_local(h_l, pulled, pushed, r_delta, impl=impl)

    if not metrics:
        return plane

    t_pull = _exch.EXCH_HIST_TRACKS.index("cap_util_pull")
    t_push = _exch.EXCH_HIST_TRACKS.index("cap_util_push")

    def plane_metrics(sh, h_l, r_delta, active_words, ok_l, fwd_l, inv_l, exch_l, eh_l):
        # the trajectory math of `plane` — same routes, same mask order —
        # plus write-only bumps from the routing statistics
        local = h_l.shape[0]
        dev = h_l.device
        i32 = torch.int32
        pulled, cnt_pull, ovf_pull = yield from _route_rows_stats(sh, h_l, inv_l, fwd_l, cap)
        pulled = torch.where(ok_l[:, None], pulled, 0) & active_words[None, :]
        pushed, cnt_push, ovf_push = yield from _route_rows_stats(
            sh, torch.where(ok_l[:, None], h_l, 0), fwd_l, inv_l, cap
        )
        pushed = pushed & active_words[None, :]
        # pull rows materialised here = this shard's direct_ok count; push
        # rows received here = every shard's ok-masked send tally to each
        # destination, summed across shards, read at this shard's index
        pull_rows = ok_l.sum(dtype=i32)
        dst = torch.div(fwd_l, local, rounding_mode="floor")
        sent = (ok_l[None, :] & (dst[None, :] == torch.arange(sh.shards, dtype=i32,
                                                               device=dev)[:, None])).sum(dim=1, dtype=i32)
        recv = yield ("sum", sent)
        one = torch.ones((), dtype=i32, device=dev)
        ovf_pull, ovf_push = ovf_pull.to(i32), ovf_push.to(i32)
        # EXCH_COUNTERS order is the wire format — keep in lockstep
        bump = torch.stack([
            one,  # ticks
            one - ovf_pull,  # a2a_pull
            one - ovf_push,  # a2a_push
            ovf_pull,  # fallback_pull
            ovf_push,  # fallback_push
            pull_rows,
            recv[sh.index],  # push_rows
            (cnt_pull > 0).sum(dtype=i32),  # dest_shards_pull
            (cnt_push > 0).sum(dtype=i32),  # dest_shards_push
        ])
        eh0 = hg.record(eh_l[0], t_pull, cnt_pull, torch.ones_like(cnt_pull, dtype=torch.bool))
        eh0 = hg.record(eh0, t_push, cnt_push, torch.ones_like(cnt_push, dtype=torch.bool))
        new_h, d_direct = _exch.exchange_local(h_l, pulled, pushed, r_delta, impl=impl)
        return new_h, d_direct, exch_l + bump[None, :], eh0[None]

    return plane_metrics


# ---------------------------------------------------------------------------
# ShardedStorm


class ShardedStorm(CheckpointableMixin):
    """``ScalableCluster`` over a shard mesh: the same ``step``/``run``
    surface, every node-indexed field split over the mesh, and the
    trajectory bitwise the single-device engine's.

    ``fused_exchange`` resolves with ``engine_scalable.
    resolve_sharded_exchange``: "auto"/"kernel" take the exchange plane
    (mode "shard_map"); "plain" is the gate twin (mode "gspmd": the
    direct round's partner rows by the uncapped all-gather, then the
    plain exchange per shard) and "off" the inline classic phases.
    ``exchange_cap_override`` forces the all-to-all bucket cap (cap=1
    overflows every route onto the fallback).  With ``ScalableParams(
    wavefront=True)`` and ``histograms=True`` the planes are fields of the
    gathered ``state`` (``first_heard`` split by node rows on the shards,
    ``hist`` whole on each): ``obs.events.scalable_wavefront_summary`` and
    ``obs.histograms.summarize`` read them."""

    def __init__(self, n: int, mesh: Optional[Mesh] = None, params=None, seed: int = 0,
                 exchange_cap_override: Optional[int] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        params = params or es.ScalableParams(n=n)
        if params.n != n:
            params = params._replace(n=n)
        shards = self.mesh.size
        self.device = self.mesh.devices[0]
        device_type = _one_device_type(self.mesh)
        if n % shards:
            raise ValueError("n=%d not divisible by mesh size %d" % (n, shards))
        requested = params.fused_exchange
        single = es.resolve_fused_exchange(params, device_type)
        mode, impl = es.resolve_sharded_exchange(params, device_type, shards)
        self.exchange_mode = mode  # "shard_map" | "gspmd"
        self.exchange_impl = impl  # the plane's kernel impl / the engine's value
        rows = n // shards
        default_cap = exchange_cap(rows, shards)
        self.exchange_cap = (
            (default_cap if exchange_cap_override is None else exchange_cap_override)
            if mode == "shard_map" else None
        )
        if mode == "shard_map" and params.exchange_metrics not in (0, shards):
            # the plane keeps one counter row per mesh shard; a foreign
            # bucket count would mislabel the wire
            raise ValueError(
                "exchange_metrics=%d must equal the mesh size (%d) under the "
                "shard_map plane (or 0 to disable)" % (params.exchange_metrics, shards)
            )
        self.params = es.resolve_scalable_params(params, device_type)
        self._plane = None
        if mode == "shard_map":
            self.params = self.params._replace(fused_exchange=impl)
            self._plane = make_exchange_plane(self.mesh, impl, cap=self.exchange_cap,
                                              metrics=bool(self.params.exchange_metrics))
        self._resolution_note = {
            "requested": requested,
            "mode": mode,
            "impl": impl,
            "shards": shards,
            "cap": self.exchange_cap,
            "single_device_resolution": single,
            # the KERNEL against the single-device pick, not the routing mode
            "differs_from_single_device": requested == "auto" and impl != single,
            "devices": [str(d) for d in self.mesh.devices],
        }
        # the exchange counters hold one row a shard when there is one a shard
        self._exch_rows = shards > 1 and self.params.exchange_metrics == shards
        route_cap = default_cap if exchange_cap_override is None else exchange_cap_override
        self._shards = [Shard(s, shards, rows, route_cap, self._exch_rows) for s in range(shards)]
        self.comm = MeshComm(self.mesh.devices)
        self._states = convert.split_scalable_state(
            es.init_state(self.params, seed=seed, device="cpu"), self.mesh.devices, self._exch_rows
        )
        self._replica_hashes = None
        self.recorder = None

    # -- the state ---------------------------------------------------------

    @property
    def shard_states(self) -> List[es.ScalableState]:
        """The per-shard states (the real ones)."""
        return list(self._states)

    @property
    def state(self) -> es.ScalableState:
        """The whole state, gathered onto the first shard's device."""
        return convert.gather_scalable_state(self._states, self.device, self._exch_rows)

    @state.setter
    def state(self, state: es.ScalableState) -> None:
        self._states = convert.split_scalable_state(state, self.mesh.devices, self._exch_rows)

    def _split_inputs(self, by_dev) -> List[es.ChurnInputs]:
        """Each shard's node columns (the last axis) of ``by_dev[device]``,
        the inputs uploaded once to each of the mesh's devices."""
        out = []
        for sh, dev in zip(self._shards, self.mesh.devices):
            cols = slice(sh.lo, sh.lo + sh.rows)
            out.append(es.ChurnInputs(*(None if x is None else x[..., cols] for x in by_dev[dev])))
        return out

    def _tick(self, shard_inputs) -> es.ScalableMetrics:
        bodies = [es.shard_tick(sh, st, inp, self.params, self._plane)
                  for sh, st, inp in zip(self._shards, self._states, shard_inputs)]
        results = lockstep(bodies, self.comm)
        self._states = [st for st, _ in results]
        return results[0][1]  # whole-cluster values, the same on every shard

    # -- the surface of ScalableCluster ------------------------------------

    def exchange_resolution(self) -> dict:
        """The mesh-aware exchange resolution (JAX's dict: requested, mode,
        impl, shards, cap, the single-device pick and whether "auto"
        diverged from it) plus ``devices``, the shards' devices."""
        note = dict(self._resolution_note)
        note["devices"] = list(note["devices"])
        return note

    def attach_recorder(self, recorder) -> None:
        """Attach an ``obs.recorder.RunRecorder``: later step()/run()
        metrics fold into it, and the resolution lands at once as a
        ``mesh_exchange_resolution`` event row."""
        recorder.describe("sim.engine_scalable[mesh]", self.params.n, self.params)
        toolkit.emit_resolution(self._resolution_note, recorder=recorder,
                                event="mesh_exchange_resolution")
        self.recorder = recorder

    def emit_resolution_stat(self, bridge) -> None:
        """Publish the resolution as ``sharded.exchange.*`` gauges on an
        ``obs.statsd_bridge.StatsdBridge`` (the divergence flag and the
        static cap)."""
        toolkit.emit_resolution(self._resolution_note, statsd=bridge,
                                gauge_prefix="sharded.exchange")

    def _recorded(self, metrics):
        metrics = metrics_to_numpy(metrics)
        if self.recorder is not None:
            self.recorder.record_ticks(metrics)
        return metrics

    def step(self, inputs: Optional[es.ChurnInputs] = None) -> es.ScalableMetrics:
        """One tick; ``inputs`` are whole-cluster ``[N]`` planes (tensors
        or arrays).  Returns its metrics as numpy scalars."""
        if inputs is None:
            inputs = es.ChurnInputs.quiet(self.params.n)
        dtypes = (torch.bool, torch.bool, torch.int32, torch.bool)
        by_dev = {dev: [None if x is None else torch.as_tensor(x, dtype=dt).to(dev)
                        for x, dt in zip(inputs, dtypes)]
                  for dev in dict.fromkeys(self.mesh.devices)}
        m = self._recorded(self._tick(self._split_inputs(by_dev)))
        self._after_ticks(1)
        return m

    def run(self, schedule) -> es.ScalableMetrics:
        """Loop the tick over a ``StormSchedule``; returns ``[T]`` numpy
        metrics (split at checkpoint-cadence lines when checkpoints are on)."""
        return self._run_chunked(schedule, self._run_window)

    def _run_window(self, schedule) -> es.ScalableMetrics:
        shard_inputs = self._split_inputs(
            {dev: schedule.as_inputs(dev) for dev in dict.fromkeys(self.mesh.devices)})
        per_tick = [self._tick([_tick_at(inp, t) for inp in shard_inputs])
                    for t in range(schedule.ticks)]
        return self._recorded(es.ScalableMetrics(*(torch.stack(f) for f in zip(*per_tick))))

    def checksums(self) -> np.ndarray:
        """[N] uint32 membership checksums."""
        if not self.params.checksum_in_tick:
            return u32.to_numpy(es.compute_checksums(self.state, self.params))
        return u32.to_numpy(torch.cat([st.checksum.to(self.device) for st in self._states]))

    def ring_checksum(self) -> int:
        """Rebuild the ring from the current truth (16 points a node, as
        ``ScalableCluster``'s default), return its digest."""
        if self._replica_hashes is None:
            self._replica_hashes = device_replica_hashes(self.params.n, 16, self.device)
        in_ring = torch.cat([(st.proc_alive & (st.truth_status <= es.SUSPECT)).to(self.device)
                             for st in self._states])
        return int(u32.to_numpy(ring_checksum(build_ring(self._replica_hashes, in_ring))))

    # -- exchange telemetry (ScalableParams.exchange_metrics) ---------------

    def drain_exchange_metrics(self, reset: bool = True, statsd=None) -> dict:
        """The per-shard exchange counters and cap-utilization histograms
        through ``obs.exchange_stats.drain`` (per-shard
        ``mesh.exchange.drain`` rows on the recorder, ``sharded.exchange.*``
        keys on ``statsd``, the wire-byte reconcile), then (``reset``)
        zeroed planes."""
        if self._states[0].exch is None:
            raise ValueError(
                "exchange telemetry is off — construct with "
                "ScalableParams(exchange_metrics=<mesh size>)"
            )
        if self._exch_rows:
            exch = torch.cat([st.exch.to(self.device) for st in self._states])
            exch_hist = torch.cat([st.exch_hist.to(self.device) for st in self._states])
        else:
            exch, exch_hist = self._states[0].exch, self._states[0].exch_hist
        s = int(exch.shape[0])
        summary = oxs.drain(
            exch, exch_hist, w=int(self._states[0].heard.shape[1]), cap=self.exchange_cap,
            local_rows=self.params.n // s, source="sim.engine_scalable[mesh]",
            recorder=self.recorder, statsd=statsd,
        )
        if reset:
            rows = 1 if self._exch_rows else s
            self._states = [st._replace(exch=_exch.init_exchange_counters(rows, dev),
                                        exch_hist=_exch.init_exchange_hist(rows, dev))
                            for st, dev in zip(self._states, self.mesh.devices)]
        return summary

    # -- checkpoint/resume (models/sim/recovery.py) -------------------------
    # Node-indexed fields split across per-shard files, one a mesh shard by
    # default; a restore reassembles them and splits them again under THIS
    # mesh, so a save resumes on any shard count and on either package.

    def _default_ckpt_shards(self) -> int:
        return self.mesh.size

    def _ckpt_spec(self) -> CheckpointSpec:
        return CheckpointSpec(es.ScalableState, self.params, es.NODE_SHARDED_FIELDS)

    def _ckpt_states(self):
        # gathered onto one device: the save reads it to the host in one transfer
        return self.state

    def _ckpt_install(self, state) -> None:
        self.state = fixup_scalable_state(state, self.params)

    def save(self, path: str, shards: Optional[int] = None) -> None:
        """Manifest-format checkpoint directory at ``path``."""
        ckpt.save_checkpoint(
            path, self.state, self.params,
            shards=self._default_ckpt_shards() if shards is None else shards,
            sharded_fields=es.NODE_SHARDED_FIELDS,
        )

    def load(self, path: str) -> None:
        """Resume from ``path`` — a legacy ``.npz`` file or a manifest
        checkpoint directory of any shard count, from either package."""
        self._ckpt_install(ckpt.load_any(path, es.ScalableState, self.params))
