"""The request-routing plane, driven by the scalable churn storm.

Counterpart of ``ringpop_tpu/models/route/plane.py``, held against it bit
for bit per tick (tests/test_torch_route_plane.py).  The JAX module
docstring gives the model; in short, each tick

- draws ``Q`` (sender, key) requests: senders uniform (threefry
  ``randint``), keys Zipf (:mod:`.traffic`), a ``multi_key_frac`` slice
  with a second key;
- routes every key under the stale ring (the previous tick's membership)
  and the truth ring (this tick's), and counts the reference proxy's
  outcomes: misroutes and their local or remote reroutes
  (send.js:181-198), keys-diverged aborts of multi-key requests
  (send.js:91-104), checksum mismatches and, under
  ``enforce_consistency``, rejects (index.js:186-193);
- keeps the ring either as the bucketed incremental ring
  (:mod:`.ring_kernel`, ``ring_impl="incremental"``, the default) or as
  the flat sorted ring rebuilt by a full sort every tick (``"full"``, the
  A/B twin).  Both give the same metrics and the same materialized ring.

:class:`RoutedStorm` couples it to the port's :class:`ScalableCluster`:
one engine tick, then one routing tick against the new truth.  It runs
on the card unless ``device="cpu"`` is passed.  ``RouteParams(histograms=
True)`` keeps the log2 counters of :data:`ROUTE_HIST_TRACKS` (write-only,
from the same masks as the counters, so identical across ring impls);
``attach_recorder`` and ``drain_histograms`` are the host halves.

Checkpoints are the JAX driver's (``models/sim/recovery.py``): two named
states, ``"sim"`` (the engine state, node fields shardable) and
``"route"`` (:class:`RouteCarry`: the stale-ring membership and the
traffic rng).  ``save(path, shards=)`` writes a manifest directory,
``load`` and ``restore_latest()`` rebuild the bucketed (or flat) ring from
the restored mask, bit for bit the incrementally kept one, and open fresh
histogram and request-trace windows under the current params.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ringpop_tpu_torch.models.ring import device as ringdev
from ringpop_tpu_torch.models.route import reqtrace as rt
from ringpop_tpu_torch.models.route import ring_kernel as rk
from ringpop_tpu_torch.models.route import traffic
from ringpop_tpu_torch.models.sim import checkpoint as ckpt
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.cluster import _tick_at, metrics_to_numpy
from ringpop_tpu_torch.models.sim.recovery import CheckpointableMixin, CheckpointSpec, states_to
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, fixup_scalable_state
from ringpop_tpu_torch.obs import histograms as oh
from ringpop_tpu_torch.obs import requests as oreq
from ringpop_tpu_torch.ops import histogram as hg
from ringpop_tpu_torch.ops import threefry, u32

# RouteState.hist rows, in order: per routed request its retry depth (1 if
# it was retried) and forwarding hops (2 if rerouted to a remote owner),
# and per tick the ring's dirty buckets
ROUTE_HIST_TRACKS = ("retry_depth", "reroute_hops", "dirty_buckets")


class RouteParams(NamedTuple):
    n: int
    replica_points: int = 16
    # hash-prefix bucket count = 2^bucket_bits; 0 = auto
    # (ring_kernel.default_bucket_bits: ~192 static points a bucket)
    bucket_bits: int = 0
    queries_per_tick: int = 4096
    key_space: int = 1 << 16
    zipf_s: float = 1.1
    # fraction of requests carrying a second key (keys-diverged plane)
    multi_key_frac: float = 0.125
    enforce_consistency: bool = True
    # "auto" -> "incremental"; "full" = the per-tick sort twin
    ring_impl: str = "auto"
    # static caps on a tick's incremental work; past either, the update
    # re-compacts every bucket (the same ring)
    max_changed: int = 128
    max_dirty: int = 512
    salt: int = 0x520337
    # log2 histograms of ROUTE_HIST_TRACKS (RouteState.hist)
    histograms: bool = False
    # sampled per-request trace records (reqtrace.py)
    reqtrace: bool = False
    req_capacity: int = 4096
    req_sample_log2: int = 4
    req_salt: int = 0x7E57A8


class RouteState(NamedTuple):
    # exactly one of (ring, flat_ring) is live, by ring_impl: the bucketed
    # state (incremental; it carries the stale membership) or the previous
    # tick's flat sorted ring (full; ``mask`` carries the membership)
    ring: Optional[rk.RingState]
    flat_ring: Optional[torch.Tensor]  # [N*R] int64 flipped keys
    mask: Optional[torch.Tensor]  # [N] bool (full impl only)
    rng: torch.Tensor  # [2] int32 — the threefry key's bits
    hist: Optional[torch.Tensor] = None  # [3, NBUCKETS] int32 (uint32 counters)
    req_buf: Optional[torch.Tensor] = None  # [cap, RECORD_WIDTH] int32
    req_head: Optional[torch.Tensor] = None  # [] int32
    req_drops: Optional[torch.Tensor] = None  # [] int32
    req_counts: Optional[torch.Tensor] = None  # [len(COUNT_FIELDS)] int32
    req_tick: Optional[torch.Tensor] = None  # [] int32


class RouteCarry(NamedTuple):
    """What a checkpoint keeps of the route state (the ring is rebuilt
    from ``mask`` on load)."""

    mask: torch.Tensor  # [N] bool
    rng: torch.Tensor  # [2] int32


class RouteMetrics(NamedTuple):
    """Per-tick routing counters (scalar int32; ``[T]`` from ``run``)."""

    route_queries: torch.Tensor  # requests with a live sender and a route
    route_misroutes: torch.Tensor  # stale owner != truth owner
    route_reroute_local: torch.Tensor  # retry landed on the sender itself
    route_reroute_remote: torch.Tensor  # retry rerouted to a new remote owner
    route_keys_diverged: torch.Tensor  # multi-key retries aborted (>1 owner)
    route_checksums_differ: torch.Tensor  # envelope checksum != dest checksum
    route_checksum_rejects: torch.Tensor  # ... and enforce_consistency rejected
    route_ring_changed: torch.Tensor  # servers whose ring membership flipped
    route_ring_dirty_buckets: torch.Tensor  # buckets those flips touched
    route_ring_full_rebuilds: torch.Tensor  # 1 = churn overflowed the caps
    route_ring_points: torch.Tensor  # active replica points in the truth ring


def resolve_ring_impl(params: RouteParams, backend: str = "cuda") -> str:
    """``"auto"`` -> ``"incremental"`` on every backend."""
    if params.ring_impl != "auto":
        if params.ring_impl not in ("full", "incremental"):
            raise ValueError(
                "ring_impl must be auto|full|incremental, got %r" % (params.ring_impl,)
            )
        return params.ring_impl
    return "incremental"


def resolve_route_params(params: RouteParams, backend: str = "cuda") -> RouteParams:
    """Pin ``ring_impl`` and ``bucket_bits`` to concrete values."""
    bits = params.bucket_bits
    if bits == 0:
        bits = rk.default_bucket_bits(params.n, params.replica_points)
    return params._replace(ring_impl=resolve_ring_impl(params, backend), bucket_bits=bits)


def _init_reqtrace(params: RouteParams, device) -> dict:
    """Fresh request-trace plane fields (empty when off)."""
    if not params.reqtrace:
        return {}
    buf, head, drops, counts, tick = rt.init_reqtrace_fields(params.req_capacity, device)
    return dict(req_buf=buf, req_head=head, req_drops=drops, req_counts=counts, req_tick=tick)


def init_route_state(
    params: RouteParams,
    buckets: rk.RingBuckets,
    reps: torch.Tensor,
    in_ring: torch.Tensor,
    seed: int = 0,
) -> RouteState:
    dev = in_ring.device
    rng = threefry.prng_key((seed ^ params.salt) & 0xFFFFFFFF, dev)
    req = _init_reqtrace(params, dev)
    hist = hg.init(len(ROUTE_HIST_TRACKS), dev) if params.histograms else None
    if resolve_ring_impl(params) == "incremental":
        return RouteState(ring=rk.full_rebuild(buckets, in_ring), flat_ring=None, mask=None,
                          rng=rng, hist=hist, **req)
    return RouteState(ring=None, flat_ring=ringdev.build_ring(reps, in_ring), mask=in_ring,
                      rng=rng, hist=hist, **req)


def route_tick(
    state: RouteState,
    buckets: rk.RingBuckets,
    reps: torch.Tensor,
    cdf: torch.Tensor,
    in_ring: torch.Tensor,
    proc_alive: torch.Tensor,
    checksums: torch.Tensor,
    params: RouteParams,
):
    """One routing tick: refresh the truth ring from ``in_ring``, route Q
    Zipf requests under the stale and truth views, count the send.js /
    index.js outcomes.  Returns ``(state', RouteMetrics)``; the metrics
    are the same under either ``ring_impl``."""
    impl = resolve_ring_impl(params)
    n = params.n
    q = params.queries_per_tick
    r = params.replica_points
    k_send, k_key1, k_key2, k_multi, rng_next = threefry.split(state.rng, 5)

    if impl == "incremental":
        # the update's own dirty stats are the reported route_ring_* numbers
        truth_ring, n_changed, n_dirty, full_rebuilds = rk.update(
            buckets, state.ring, in_ring,
            max_changed=params.max_changed, max_dirty=params.max_dirty,
        )

        def lookup_stale(kh):
            return rk.lookup(state.ring, kh)

        def lookup_truth(kh):
            return rk.lookup(truth_ring, kh)

        ring_points = truth_ring.n_points
        new_state = RouteState(ring=truth_ring, flat_ring=None, mask=None, rng=rng_next)
    else:  # "full": the per-tick sort twin, reporting the same stats
        prev_mask = state.mask
        n_changed, _dirty, n_dirty, overflow = rk.dirty_stats(
            buckets, in_ring != prev_mask, params.max_changed, params.max_dirty
        )
        full_rebuilds = overflow.to(torch.int32)
        stale_flat = state.flat_ring
        stale_points = ringdev.ring_size(prev_mask, r)
        truth_flat = ringdev.build_ring(reps, in_ring)
        ring_points = ringdev.ring_size(in_ring, r)

        def lookup_stale(kh):
            return ringdev.lookup(stale_flat, stale_points, kh)

        def lookup_truth(kh):
            return ringdev.lookup(truth_flat, ring_points, kh)

        new_state = RouteState(ring=None, flat_ring=truth_flat, mask=in_ring, rng=rng_next)
    if params.reqtrace:
        # the trace plane rides unchanged until the emission below
        new_state = new_state._replace(
            req_buf=state.req_buf, req_head=state.req_head, req_drops=state.req_drops,
            req_counts=state.req_counts, req_tick=state.req_tick,
        )

    # -- traffic ---------------------------------------------------------
    senders = threefry.randint_i32(k_send, (q,), 0, n)
    send_idx = senders.long()
    kh1 = traffic.key_hashes(traffic.sample_keys(k_key1, cdf, q))
    own1_stale = lookup_stale(kh1)
    own1_truth = lookup_truth(kh1)
    # a request exists when its sender is up and the stale view had an owner
    sendable = proc_alive[send_idx] & (own1_stale >= 0)

    # -- misroute + retry reroute (send.js:91-208) -----------------------
    misroute = sendable & (own1_truth != own1_stale)
    reroute_local = misroute & (own1_truth == senders)
    reroute_remote = misroute & (own1_truth != senders) & (own1_truth >= 0)

    # -- checksum plane (index.js:168-229) -------------------------------
    dest = own1_stale.clamp(0, n - 1)
    differ = sendable & (checksums[send_idx] != checksums[dest.long()])
    rejects = differ if params.enforce_consistency else torch.zeros_like(differ)

    # -- keys-diverged (send.js:91-104) ----------------------------------
    kh2 = traffic.key_hashes(traffic.sample_keys(k_key2, cdf, q))
    own2_stale = lookup_stale(kh2)
    own2_truth = lookup_truth(kh2)
    is_multi = threefry.uniform_f32(k_multi, (q,)) < float(np.float32(params.multi_key_frac))
    # the pair rode one envelope only if both keys agreed at send time
    multi_ok = is_multi & sendable & (own2_stale == own1_stale)
    retried = misroute | rejects
    diverged = multi_ok & retried & (own1_truth != own2_truth)

    if params.histograms:
        # write-only; the masks are the counters', so both impls agree
        hist = hg.record(state.hist, ROUTE_HIST_TRACKS.index("retry_depth"),
                         retried.to(torch.int32), sendable)
        hist = hg.record(hist, ROUTE_HIST_TRACKS.index("reroute_hops"),
                         1 + reroute_remote.to(torch.int32), sendable)
        hist = hg.record_count(hist, ROUTE_HIST_TRACKS.index("dirty_buckets"), n_dirty)
        new_state = new_state._replace(hist=hist)

    if params.reqtrace:
        new_state = rt.record_tick_requests(
            new_state, params, kh=kh1, senders=senders, dest=dest, own_truth=own1_truth,
            sendable=sendable, misroute=misroute, reroute_local=reroute_local,
            reroute_remote=reroute_remote, differ=differ, rejects=rejects, multi_ok=multi_ok,
            diverged=diverged, retried=retried,
        )

    counted = torch.stack([sendable, misroute, reroute_local, reroute_remote, diverged,
                           differ, rejects]).sum(dim=1, dtype=torch.int32)
    return new_state, RouteMetrics(
        *counted.unbind(),
        route_ring_changed=n_changed,
        route_ring_dirty_buckets=n_dirty,
        route_ring_full_rebuilds=full_rebuilds,
        route_ring_points=ring_points.to(torch.int32),
    )


def in_ring_mask(state: es.ScalableState) -> torch.Tensor:
    """Ring membership from the engine's truth: alive and suspect servers
    stay in the ring (on_membership_event.js:106-134)."""
    return state.proc_alive & (state.truth_status <= es.SUSPECT)


class RoutedStorm(CheckpointableMixin):
    """``ScalableCluster`` plus the routing plane: every engine tick is
    followed by a routing tick against the new truth (the truth ring) and
    the pre-tick view (the stale ring).  ``step``/``run`` return
    ``(ScalableMetrics, RouteMetrics)`` as numpy."""

    def __init__(
        self,
        n: int,
        params: Optional[es.ScalableParams] = None,
        route: Optional[RouteParams] = None,
        replica_points: int = 16,
        seed: int = 0,
        device=None,
    ):
        self.cluster = ScalableCluster(n=n, params=params, replica_points=replica_points,
                                       seed=seed, device=device)
        self.device = self.cluster.device
        if not self.cluster.params.checksum_in_tick:
            raise ValueError(
                "the routing plane's checksum counters read the in-tick "
                "checksums — construct with checksum_in_tick=True"
            )
        route = route or RouteParams(n=n, replica_points=replica_points)
        if route.n != n or route.replica_points != replica_points:
            route = route._replace(n=n, replica_points=replica_points)
        self.route_params = resolve_route_params(route, self.device.type)
        self.reps = ringdev.device_replica_hashes(n, replica_points, self.device)
        self.buckets = rk.build_buckets(self.reps, self.route_params.bucket_bits, self.device)
        self.cdf = traffic.zipf_cdf(self.route_params.key_space, self.route_params.zipf_s,
                                    self.device)
        self.rstate = init_route_state(self.route_params, self.buckets, self.reps,
                                       in_ring_mask(self.cluster.state), seed=seed)
        # optional run log (attach_recorder)
        self.recorder = None

    # -- driving ----------------------------------------------------------

    def _tick(self, inputs: es.ChurnInputs):
        est, em = es.tick(self.cluster.state, inputs, self.cluster.params)
        self.cluster.state = est
        self.rstate, rm = route_tick(
            self.rstate, self.buckets, self.reps, self.cdf, in_ring_mask(est),
            est.proc_alive, est.checksum, self.route_params,
        )
        return em, rm

    def step(self, inputs: Optional[es.ChurnInputs] = None):
        """One tick; returns its metrics as numpy scalars."""
        if inputs is None:
            inputs = es.ChurnInputs.quiet(self.route_params.n, self.device)
        em, rm = self._tick(inputs)
        out = self._record(metrics_to_numpy(em), metrics_to_numpy(rm))
        self._after_ticks(1)
        return out

    def run(self, schedule):
        """Loop the tick over a ``StormSchedule``; returns ``[T]`` numpy
        stacks of ``(ScalableMetrics, RouteMetrics)``.  With a checkpoint
        cadence on the run splits at the cadence lines (bitwise-neutral)."""
        return self._run_chunked(schedule, self._run_window)

    def _run_window(self, schedule):
        inputs = schedule.as_inputs(self.device)
        per_tick = [self._tick(_tick_at(inputs, t)) for t in range(schedule.ticks)]
        ems, rms = zip(*per_tick)
        return self._record(
            metrics_to_numpy(es.ScalableMetrics(*(torch.stack(f) for f in zip(*ems)))),
            metrics_to_numpy(RouteMetrics(*(torch.stack(f) for f in zip(*rms)))),
        )

    # -- telemetry --------------------------------------------------------

    def attach_recorder(self, recorder) -> None:
        """Attach an ``obs.recorder.RunRecorder``: every step's and run's
        engine and routing metrics fold into it, one row a tick; the drains
        log their rows there too."""
        recorder.describe("sim.engine_scalable+route", self.route_params.n, self.cluster.params,
                          route_params=self.route_params._asdict())
        self.recorder = recorder

    def _record(self, em, rm):
        if self.recorder is not None:
            rows = dict(em._asdict())
            rows.update(rm._asdict())
            self.recorder.record_ticks(rows)
        return em, rm

    def drain_histograms(self, reset: bool = True, statsd=None) -> dict:
        """Drain both histogram planes — the routing plane's
        (``RouteState.hist``) and the engine's (``ScalableState.hist``, when
        on) — into ``{"route": ..., "sim": ...}`` summaries, one
        ``hist.drain`` row each on the attached recorder and timer keys on
        ``statsd``, then (``reset``) zeroed counters."""
        st = self.cluster.state
        if self.rstate.hist is None and st.hist is None:
            raise ValueError(
                "histograms are off — construct with RouteParams(histograms=True) "
                "and/or ScalableParams(histograms=True)"
            )
        out = {}
        if self.rstate.hist is not None:
            out["route"] = oh.drain(self.rstate.hist, ROUTE_HIST_TRACKS, "route",
                                    recorder=self.recorder, statsd=statsd)
            if reset:
                self.rstate = self.rstate._replace(
                    hist=hg.init(len(ROUTE_HIST_TRACKS), self.device)
                )
        if st.hist is not None:
            out["sim"] = oh.drain(st.hist, es.SCALABLE_HIST_TRACKS, "sim.engine_scalable",
                                  recorder=self.recorder, statsd=statsd)
            if reset:
                self.cluster.state = st._replace(
                    hist=hg.init(len(es.SCALABLE_HIST_TRACKS), self.device)
                )
        return out

    # -- request traces ---------------------------------------------------

    def drain_requests(self, reset: bool = True, statsd=None):
        """Decode the sampled request-trace window (``obs.requests.drain``'s
        dict: records, counts, drops), with a ``reqtrace.drain`` row on the
        attached recorder and ``sim.reqtrace.*`` keys on ``statsd``.  ``reset=True`` zeroes the buffer and counters;
        the plane's tick stamp keeps running."""
        st = self.rstate
        if st.req_buf is None:
            raise ValueError(
                "request tracing is off — construct with RouteParams(reqtrace=True)"
            )

        def host(t):
            return t.to("cpu").numpy()

        out = oreq.drain(host(st.req_buf), host(st.req_head), host(st.req_drops),
                         host(st.req_counts), sample_log2=self.route_params.req_sample_log2,
                         source="route", recorder=self.recorder, statsd=statsd)
        if reset:
            buf, head, drops, counts, _ = rt.init_reqtrace_fields(
                self.route_params.req_capacity, self.device
            )
            self.rstate = st._replace(req_buf=buf, req_head=head, req_drops=drops,
                                      req_counts=counts)
        return out

    # -- inspection -------------------------------------------------------

    def _truth_flat(self) -> torch.Tensor:
        if self.route_params.ring_impl == "incremental":
            return rk.materialize(self.rstate.ring,
                                  self.route_params.n * self.route_params.replica_points)
        return self.rstate.flat_ring

    def truth_ring(self) -> np.ndarray:
        """The flat sorted truth ring as uint64 keys (the JAX layout),
        materialized from the bucketed state under "incremental"."""
        return ringdev.ring_to_numpy(self._truth_flat())

    def ring_checksum(self) -> int:
        return int(u32.to_numpy(ringdev.ring_checksum(self._truth_flat())))

    # -- checkpoint/resume ------------------------------------------------

    def _route_carry(self) -> RouteCarry:
        mask = (self.rstate.ring.mask if self.route_params.ring_impl == "incremental"
                else self.rstate.mask)
        return RouteCarry(mask=mask, rng=self.rstate.rng)

    def _rebuild_route_state(self, carry: RouteCarry) -> RouteState:
        mask, rng = carry.mask.to(self.device), carry.rng.to(self.device)
        # telemetry, not trajectory: a restore starts fresh histogram
        # counters and a fresh request-trace window under the current params
        hist = hg.init(len(ROUTE_HIST_TRACKS), self.device) if self.route_params.histograms else None
        req = _init_reqtrace(self.route_params, self.device)
        if self.route_params.ring_impl == "incremental":
            return RouteState(ring=rk.full_rebuild(self.buckets, mask), flat_ring=None, mask=None,
                              rng=rng, hist=hist, **req)
        return RouteState(ring=None, flat_ring=ringdev.build_ring(self.reps, mask), mask=mask,
                          rng=rng, hist=hist, **req)

    def _ckpt_spec(self) -> CheckpointSpec:
        return CheckpointSpec(
            state_cls={"sim": es.ScalableState, "route": RouteCarry},
            params={"sim": self.cluster.params, "route": self.route_params},
            sharded_fields={"sim": es.NODE_SHARDED_FIELDS, "route": frozenset({"mask"})},
        )

    def _ckpt_states(self):
        return {"sim": self.cluster.state, "route": self._route_carry()}

    def _ckpt_install(self, states) -> None:
        self.cluster.state = fixup_scalable_state(states_to(states["sim"], self.device),
                                                  self.cluster.params)
        self.rstate = self._rebuild_route_state(states["route"])

    def save(self, path: str, shards: int = 1) -> None:
        """Manifest-format checkpoint directory at ``path``."""
        spec = self._ckpt_spec()
        ckpt.save_checkpoint(path, self._ckpt_states(), spec.params, shards=shards,
                             sharded_fields=spec.sharded_fields)

    def load(self, path: str) -> None:
        spec = self._ckpt_spec()
        self._ckpt_install(ckpt.load_checkpoint(path, spec.state_cls, spec.params))
