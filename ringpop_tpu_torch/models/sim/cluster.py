"""SimCluster — the host-side loop around the port's batched SWIM simulator.

Counterpart of ``ringpop_tpu/models/sim/cluster.py`` (the role of the
reference's tick-cluster harness): spawn N simulated nodes, join them, tick
the protocol, inject faults and watch convergence by grouping nodes on
their membership checksums.

- ``step()`` runs one tick with per-call events (interactive use);
- ``run(schedule)`` loops the tick over a dense ``EventSchedule`` (the
  throughput path; the JAX cluster scans it).

Under ``parity_recompute="bounded"`` a tick whose dirty rows or changed
cells overflow the bounded chunk left stale checksums behind; the cluster
then discards the whole step or window and replays it from the pre-run
state under an exact shape — "full" on the fused checksum pipeline,
"gated" on the classic one (``parity_replays`` counts these).

The obs planes' host halves: ``drain_events`` / ``event_drops`` /
``first_heard`` / ``export_flight_trace`` (``SimParams(flight_recorder=
True)``), ``drain_histograms`` (``histograms=True``; ``statsd=`` takes an
``obs.statsd_bridge.StatsdBridge``), and ``attach_recorder``, which folds
every step's and window's metrics and every replay into an
``obs.recorder.RunRecorder``.  Each drain resets the device counters after
its sinks took the window; draining is trajectory-neutral.

Checkpoints (``models/sim/recovery.py``): ``save``/``load`` write and read
the JAX package's legacy file (``load`` also takes a manifest directory),
``enable_checkpoints(dir, every=k)`` saves every k driven ticks (``run``
splits its window at those lines, bitwise-neutrally) and
``restore_latest()`` resumes from the newest valid checkpoint;
:func:`fixup_sim_state` rebuilds the fused record cache and the obs planes
for the resuming params.

The cluster runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.models.sim import checkpoint as ckpt
from ringpop_tpu_torch.models.sim import engine, flight
from ringpop_tpu_torch.models.sim.recovery import CheckpointableMixin, CheckpointSpec, states_to
from ringpop_tpu_torch.models.sim.schedule import DeviceScheduleMixin
from ringpop_tpu_torch.obs import events as obs_events
from ringpop_tpu_torch.obs import histograms as oh
from ringpop_tpu_torch.ops import checksum_encode as ce
from ringpop_tpu_torch.ops import fused_checksum as fc
from ringpop_tpu_torch.ops import histogram as hg
from ringpop_tpu_torch.ops import toolkit, u32


def default_addresses(n: int, base_port: int = 3000, host: str = "127.0.0.1") -> List[str]:
    return ["%s:%d" % (host, base_port + i) for i in range(n)]


@dataclasses.dataclass
class EventSchedule(DeviceScheduleMixin):
    """Dense per-tick fault-injection plan for ``run()``."""

    ticks: int
    n: int
    kill: np.ndarray = None  # [T, N] bool
    revive: np.ndarray = None
    join: np.ndarray = None
    partition: np.ndarray = None  # [T, N] int32, -1 keeps current
    resume: np.ndarray = None  # [T, N] bool, or None (no SIGCONTs)
    leave: np.ndarray = None  # [T, N] bool, or None (no graceful leaves)

    def __post_init__(self):
        T, n = self.ticks, self.n
        if self.kill is None:
            self.kill = np.zeros((T, n), bool)
        if self.revive is None:
            self.revive = np.zeros((T, n), bool)
        if self.join is None:
            self.join = np.zeros((T, n), bool)
        if self.partition is None:
            self.partition = np.full((T, n), -1, np.int32)

    def _build_inputs(self, device) -> engine.TickInputs:
        def t(a, dtype):
            return None if a is None else torch.as_tensor(a, dtype=dtype, device=device)

        return engine.TickInputs(
            kill=t(self.kill, torch.bool),
            revive=t(self.revive, torch.bool),
            join=t(self.join, torch.bool),
            partition=t(self.partition, torch.int32),
            resume=t(self.resume, torch.bool),
            leave=t(self.leave, torch.bool),
        )

    @staticmethod
    def churn_window(
        ticks: int, n: int, victims: Optional[Sequence[int]] = None
    ) -> "EventSchedule":
        """The shared churn-capture shape: a kill wave early in the window,
        revive at mid-window (suspect -> faulty escalation and the rejoin
        dissemination both land inside the window)."""
        sched = EventSchedule(ticks=ticks, n=n)
        if victims is None:
            victims = (3 % n, n // 2, max(0, n - 5))
        kill_at = min(4, ticks - 1)
        revive_at = min(max(kill_at + 1, ticks // 2), ticks - 1)
        for v in victims:
            sched.kill[kill_at, v % n] = True
            if revive_at > kill_at:
                sched.revive[revive_at, v % n] = True
        return sched


def _tick_at(inputs, t: int):
    """Tick ``t``'s row of a ``[T, N]`` input tuple (either engine's)."""
    return type(inputs)(*(None if x is None else x[t] for x in inputs))


def metrics_to_numpy(metrics):
    """A metrics tuple (either engine's) with every field as numpy."""
    return type(metrics)(*(x.to("cpu").numpy() for x in metrics))


def fixup_sim_state(
    state: engine.SimState, params: engine.SimParams, universe: ce.Universe
) -> engine.SimState:
    """Align a just-loaded SimState with the resuming engine's params (the
    JAX cluster's ``fixup_sim_state``; the checkpoint's trajectory-neutral
    knobs may differ between save and resume).  Runs on the state's
    device."""
    dev = state.known.device
    if engine.resolve_fused_checksum(params) == "on":
        # the record cache is a pure function of (known, status, inc):
        # rebuild it UNCONDITIONALLY.  A stored cache cannot be trusted —
        # an unfused resume in between carries it through unchanged while
        # the views evolve, and hashing those stale bytes would break parity
        rec_b, rec_l = fc.member_records(
            universe, state.known, state.status, engine.stamp_to_ms(state.inc, params),
            params.max_digits,
        )
        state = state._replace(rec_bytes=rec_b, rec_len=rec_l)
    elif state.rec_bytes is not None:
        # unfused resume of a fused checkpoint: drop the cache so this run
        # never saves forward bytes it does not maintain
        state = state._replace(rec_bytes=None, rec_len=None)
    # flight-recorder plane: telemetry, not trajectory.  A recorder-on
    # resume starts a fresh buffer when the checkpoint has none or its
    # capacity differs (keeping the wavefront); a recorder-off resume drops it
    if params.flight_recorder:
        buf = state.ev_buf
        if buf is None or buf.shape[0] != params.event_capacity:
            ev_buf, ev_head, ev_drops, first_heard = flight.init_recorder_fields(
                params.n, params.event_capacity, dev
            )
            if state.first_heard is not None:
                first_heard = state.first_heard
            state = state._replace(ev_buf=ev_buf, ev_head=ev_head, ev_drops=ev_drops,
                                   first_heard=first_heard)
    elif state.ev_buf is not None:
        state = state._replace(ev_buf=None, ev_head=None, ev_drops=None, first_heard=None)
    # latency-histogram plane: the same contract; counters start fresh
    if params.histograms and state.hist is None:
        state = state._replace(hist=hg.init(len(engine.HIST_TRACKS), dev))
    elif not params.histograms and state.hist is not None:
        state = state._replace(hist=None)
    return state


class SimCluster(CheckpointableMixin):
    def __init__(
        self,
        n: Optional[int] = None,
        addresses: Optional[Sequence[str]] = None,
        params: Optional[engine.SimParams] = None,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        if addresses is None:
            if n is None:
                raise ValueError("need n or addresses")
            addresses = default_addresses(n)
        self.universe = ce.Universe.from_addresses(addresses)
        n = self.universe.n
        params = params or engine.SimParams(n=n)
        if params.n != n:
            params = params._replace(n=n)
        # the requests before resolution, for attach_recorder's notes
        self._requested_knobs = {
            k: getattr(params, k) for k in ("fused_checksum", "fused_tick", "parity_recompute")
        }
        # pin the hash kernels' knob at construction, as the JAX cluster
        # pins hash_impl, then the tick and checksum knobs
        params = params._replace(hash_impl=engine.resolve_hash_impl(params, self.device.type))
        self.params = engine.resolve_auto_parity(params, self.device.type)
        self.state = engine.init_state(
            self.params, seed=seed, universe=self.universe, device=self.device
        )
        # bounded-parity overflow replays (a window that replayed paid the
        # exact-shape cost too)
        self.parity_replays = 0
        # optional run log (attach_recorder)
        self.recorder = None

    def attach_recorder(self, recorder) -> None:
        """Attach an ``obs.recorder.RunRecorder``: later step()/run()
        metrics fold into it, overflow replays log as events, and every
        resolved fused-op knob lands as an ``op_resolution`` row."""
        recorder.describe("sim.engine", self.params.n, self.params)
        for knob in ("fused_checksum", "fused_tick", "parity_recompute"):
            toolkit.emit_resolution(
                toolkit.resolution_note(
                    knob, self._requested_knobs[knob], getattr(self.params, knob),
                    self.device.type,
                ),
                recorder=recorder,
            )
        self.recorder = recorder

    # -- bounded-parity overflow fallback --------------------------------

    @property
    def _bounded_parity(self) -> bool:
        return (
            self.params.checksum_mode == "farmhash"
            and self.params.parity_recompute == "bounded"
        )

    def _exact_params(self) -> engine.SimParams:
        """The exact-recompute twin config for overflow replays: "full" for
        fused runs, "gated" for unfused ones (bit-identical trajectories)."""
        return self.params._replace(
            parity_recompute=engine.resolve_exact_recompute(self.params)
        )

    def _tick(self, state, inputs, params=None):
        return engine.tick(state, inputs, params or self.params, self.universe)

    def _replayed(self) -> engine.SimParams:
        """Count a bounded-parity overflow replay (and log it); returns the
        exact-shape params to replay under."""
        self.parity_replays += 1
        exact = self._exact_params()
        if self.recorder is not None:
            self.recorder.record_event(
                "parity_overflow_replay", replays=self.parity_replays,
                shape=exact.parity_recompute,
            )
        return exact

    # -- lifecycle --------------------------------------------------------

    def quiet_inputs(self) -> engine.TickInputs:
        return engine.TickInputs.quiet(self.params.n, self.device)

    def _mask(self, indices: Sequence[int]) -> torch.Tensor:
        m = np.zeros(self.params.n, bool)
        m[list(indices)] = True
        return torch.as_tensor(m, device=self.device)

    def bootstrap(self) -> engine.TickMetrics:
        """Join every node at once (the tick-cluster 'j' command)."""
        return self.step(self.quiet_inputs()._replace(
            join=torch.ones(self.params.n, dtype=torch.bool, device=self.device)
        ))

    def step(self, inputs: Optional[engine.TickInputs] = None) -> engine.TickMetrics:
        if inputs is None:
            inputs = self.quiet_inputs()
        pre = self.state
        self.state, metrics = self._tick(pre, inputs)
        if self._bounded_parity and int(metrics.parity_overflow) > 0:
            self.state, metrics = self._tick(pre, inputs, self._replayed())
        metrics = metrics_to_numpy(metrics)
        if self.recorder is not None:
            self.recorder.record_ticks(metrics)
        self._after_ticks(1)
        return metrics

    def run(self, schedule: EventSchedule) -> engine.TickMetrics:
        """Loop the tick over a dense event schedule; returns a TickMetrics
        of numpy ``[T]`` arrays.  With a checkpoint cadence on
        (``enable_checkpoints(every=k)``) the run splits at the cadence
        lines, each window replayed on its own overflow — state and
        metrics bitwise those of the unsplit run."""
        return self._run_chunked(schedule, self._run_schedule)

    def _run_schedule(self, schedule: EventSchedule) -> engine.TickMetrics:
        inputs = schedule.as_inputs(self.device)
        pre = self.state
        self.state, metrics = self._run_window(pre, inputs, schedule.ticks, self.params)
        if self._bounded_parity and int(metrics.parity_overflow.sum()) > 0:
            self.state, metrics = self._run_window(pre, inputs, schedule.ticks, self._replayed())
        metrics = metrics_to_numpy(metrics)
        if self.recorder is not None:
            self.recorder.record_ticks(metrics)
        return metrics

    def _run_window(self, state, inputs, ticks, params):
        rows = []
        for t in range(ticks):
            state, m = self._tick(state, _tick_at(inputs, t), params)
            rows.append(m)
        stacked = engine.TickMetrics(
            *(torch.stack([getattr(m, f) for m in rows]) for f in engine.TickMetrics._fields)
        )
        return state, stacked

    def run_until_converged(self, max_ticks: int = 200, quiet_after: int = 0) -> int:
        """Tick until every live+ready node shares one checksum; returns the
        number of ticks taken (or -1 if not converged within max_ticks)."""
        for t in range(max_ticks):
            m = self.step()
            if t >= quiet_after and bool(m.converged):
                return t + 1
        return -1

    # -- fault injection (tick-cluster k/K/l keys) ------------------------

    def kill(self, indices: Sequence[int]) -> engine.TickMetrics:
        return self.step(self.quiet_inputs()._replace(kill=self._mask(indices)))

    def revive(self, indices: Sequence[int]) -> engine.TickMetrics:
        return self.step(self.quiet_inputs()._replace(revive=self._mask(indices)))

    def suspend(self, indices: Sequence[int]) -> engine.TickMetrics:
        """SIGSTOP: the process stops answering but keeps its state."""
        return self.kill(indices)

    def resume(self, indices: Sequence[int]) -> engine.TickMetrics:
        """SIGCONT: a suspended process returns with its state intact."""
        return self.step(self.quiet_inputs()._replace(resume=self._mask(indices)))

    def leave(self, indices: Sequence[int]) -> engine.TickMetrics:
        """Graceful leave (membership.makeLeave + gossip stop)."""
        return self.step(self.quiet_inputs()._replace(leave=self._mask(indices)))

    def rejoin(self, indices: Sequence[int]) -> engine.TickMetrics:
        """Rejoin left nodes: alive with a fresh incarnation."""
        return self.step(self.quiet_inputs()._replace(join=self._mask(indices)))

    def partition(self, groups: Sequence[int]) -> engine.TickMetrics:
        return self.step(self.quiet_inputs()._replace(
            partition=torch.as_tensor(np.asarray(groups, np.int32), device=self.device)
        ))

    # -- flight recorder (SimParams.flight_recorder) ----------------------

    def _need(self, field: str, knob: str):
        t = getattr(self.state, field)
        if t is None:
            raise ValueError("%s is off — construct with SimParams(%s=True)" % (knob, knob))
        return t

    def drain_events(self, reset: bool = True) -> List[dict]:
        """Decode the flight-recorder buffer into host event dicts
        (``obs.events``), log a ``flight_drain`` row on the attached
        recorder, then (``reset``) clear the write head and drop counter.
        Protocol state is untouched, so draining mid-run is neutral."""
        buf = self._need("ev_buf", "flight_recorder")
        head, drops = int(self.state.ev_head), int(self.state.ev_drops)
        # only the valid rows cross to the host
        decoded = obs_events.decode_events(buf[:head].to("cpu").numpy(), head, drops)
        if self.recorder is not None:
            self.recorder.record_event("flight_drain", events=len(decoded), drops=drops)
        if reset:
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            self.state = self.state._replace(ev_head=zero, ev_drops=zero.clone())
        return decoded

    def event_drops(self) -> int:
        """Events dropped since the last drain (0 with the recorder off)."""
        return 0 if self.state.ev_drops is None else int(self.state.ev_drops)

    def first_heard(self) -> np.ndarray:
        """The wavefront matrix: tick at which observer i first adopted j's
        current rumor (-1 = born-with view only)."""
        return self._need("first_heard", "flight_recorder").to("cpu").numpy()

    def export_flight_trace(self, events=None, include_pings: bool = False) -> dict:
        """Chrome-trace JSON dict of a decoded event stream (drains the
        buffer when ``events`` is omitted)."""
        from ringpop_tpu_torch.obs.chrome_trace import export_chrome_trace

        if events is None:
            events = self.drain_events()
        return export_chrome_trace(
            events, n=self.params.n, period_ms=self.params.period_ms,
            addresses=list(self.universe.addresses), include_pings=include_pings,
        )

    # -- latency histograms (SimParams.histograms) ------------------------

    def drain_histograms(self, reset: bool = True, statsd=None) -> dict:
        """Per-track summaries (exact p50/p95/p99, ``obs.histograms``) of
        the device counters, a ``hist.drain`` row on the attached recorder,
        then (``reset``) zeroed counters; ``statsd`` (a ``StatsdBridge``)
        gets the percentile timer keys."""
        hist = self._need("hist", "histograms")
        summary = oh.drain(hist, engine.HIST_TRACKS, "sim.engine", recorder=self.recorder,
                           statsd=statsd)
        if reset:
            self.state = self.state._replace(hist=hg.init(len(engine.HIST_TRACKS), self.device))
        return summary

    # -- inspection -------------------------------------------------------

    def checksums(self) -> np.ndarray:
        """[N] uint32 membership checksums."""
        return u32.to_numpy(self.state.checksum)

    def checksum_groups(self) -> Dict[int, List[str]]:
        """Group live+ready nodes by membership checksum (tick-cluster.js:87-114)."""
        cs = self.checksums()
        alive = (self.state.proc_alive & self.state.ready).to("cpu").numpy()
        groups: Dict[int, List[str]] = {}
        for i, a in enumerate(self.universe.addresses):
            if alive[i]:
                groups.setdefault(int(cs[i]), []).append(a)
        return groups

    def membership_of(self, i: int) -> List[dict]:
        """Node i's member list (sorted by address), with incarnation stamps
        converted back to the reference's epoch-ms numbers."""
        known = self.state.known[i].to("cpu").numpy()
        status = self.state.status[i].to("cpu").numpy()
        inc = self.state.inc[i].to("cpu").numpy()
        p = self.params
        out = []
        for j, a in enumerate(self.universe.addresses):
            if known[j]:
                s = int(inc[j])
                out.append({
                    "address": a,
                    "status": ce.STATUS_STRINGS[int(status[j])],
                    "incarnationNumber": p.epoch_ms + (s - 1) * p.period_ms if s > 0 else 0,
                })
        return out

    def checksum_string_of(self, i: int) -> str:
        return ";".join(
            "%s%s%d" % (m["address"], m["status"], m["incarnationNumber"])
            for m in self.membership_of(i)
        )

    # -- checkpoint/resume ------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's legacy single-file checkpoint at ``path``."""
        ckpt.save_state(path, self.state, self.params)

    def load(self, path: str) -> None:
        """Resume from ``path`` — a legacy ``.npz`` file or a manifest
        checkpoint directory (any shard count), written by either package."""
        self._ckpt_install(ckpt.load_any(path, engine.SimState, self.params))

    def _ckpt_spec(self) -> CheckpointSpec:
        # sharded_fields=None -> dynamic: every non-scalar SimState field
        # is node-leading
        return CheckpointSpec(engine.SimState, self.params, None)

    def _ckpt_states(self):
        return self.state

    def _ckpt_install(self, state) -> None:
        self.state = fixup_sim_state(states_to(state, self.device), self.params, self.universe)
