"""Preemption-safe recovery plane: cadence, rotation, newest-valid scan.

Counterpart of ``ringpop_tpu/models/sim/recovery.py``.
:mod:`.checkpoint` writes one atomic, self-verifying checkpoint; this
module makes a long-running driver survive being killed with it:

- :class:`CheckpointManager` owns a checkpoint **directory family**
  (``ckpt-<tick>`` manifest directories under one root), saves on demand,
  rotates with keep-last-K garbage collection, and at restore time scans
  newest-first, **falling back past corrupt checkpoints** (torn
  manifests, truncated or bit-rotted array files, missing shards), each
  failure surfaced as a ``ckpt.corrupt`` event instead of a crash or a
  silent resume.
- :class:`CheckpointableMixin` gives ``SimCluster``, ``ScalableCluster``
  and ``RoutedStorm`` the same surface: ``enable_checkpoints(dir,
  every=..., keep=..., shards=...)``, ``checkpoint_now()``,
  ``restore_latest()``, and the cadence hook that splits a ``run()`` at
  checkpoint lines.  Splitting a run at tick k is trajectory-neutral (the
  state threads through unchanged; the per-tick metric stacks are
  concatenated), pinned bitwise by tests/test_torch_recovery.py.

A save reads the driver's states to the host in one transfer
(``convert.states_arrays``); a restore loads onto the CPU and the driver
moves the states to its device.  With ``every=0`` nothing here touches a
tick: no save, no host read, no launch.

Telemetry: ``ckpt.saved`` / ``ckpt.corrupt`` / ``ckpt.resumed`` /
``ckpt.gc`` flow as run-log event rows through an attached
``obs.recorder.RunRecorder`` and as counters through an attached statsd
client (key map in ``obs.statsd_bridge.CKPT_KEY_MAP``).  The split times
of the last save and restore are kept in ``last_save`` and
``last_restore``.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import checkpoint as ckpt

CKPT_PREFIX = "ckpt-"
_CKPT_RE = re.compile(r"^ckpt-(\d{10})$")


def checkpoint_name(tick: int) -> str:
    return "%s%010d" % (CKPT_PREFIX, tick)


class CheckpointSpec(NamedTuple):
    """What a driver checkpoints: state classes, params, and which
    fields shard along the node axis (None = dynamic: every array field
    with ndim >= 1, the full-engine rule where every non-scalar field is
    node-leading)."""

    state_cls: Any  # Type | {name: Type}
    params: Any = None  # params NamedTuple | {name: params}
    sharded_fields: Any = None  # frozenset | {name: frozenset} | None


def _dynamic_sharded_fields(states: Any) -> Dict[str, frozenset]:
    """Per-state 'shard every non-scalar array field' fallback (reads
    ``.ndim`` off the tensors — no transfer just to inspect a shape)."""
    smap = states if isinstance(states, dict) else {"state": states}
    return {
        name: frozenset(f for f in st._fields if getattr(getattr(st, f), "ndim", 0) >= 1)
        for name, st in smap.items()
    }


class CheckpointManager:
    """Rotated, self-verifying checkpoint family under one directory.

    ``keep`` counts VALID checkpoints: garbage collection deletes
    everything strictly older than the keep-th newest valid one, so a
    corrupt newest checkpoint can never evict the good fallback behind
    it.  ``restore_latest`` returns ``(tick, states)`` — tensors on the
    CPU — from the newest checkpoint that loads clean, recording every
    corrupt one it skipped in :attr:`last_errors` (and as ``ckpt.corrupt``
    events)."""

    def __init__(
        self,
        directory: str,
        spec: CheckpointSpec,
        *,
        keep: int = 3,
        shards: int = 1,
        recorder: Any = None,
        statsd: Any = None,
        clock=time.perf_counter,
    ):
        if keep < 1:
            raise ValueError("keep must be >= 1, got %d" % keep)
        if shards < 1:
            raise ValueError("shards must be >= 1, got %d" % shards)
        self.directory = directory
        self.spec = spec
        self.keep = keep
        self.shards = shards
        self.recorder = recorder
        self.statsd = statsd
        self._clock = clock
        # (tick, path, error) triples from the most recent restore scan
        self.last_errors: List[Tuple[int, str, ckpt.CheckpointError]] = []
        # split seconds of the most recent save and restore scan
        self.last_save: Dict[str, Any] = {}
        self.last_restore: Dict[str, Any] = {}
        os.makedirs(directory, exist_ok=True)

    # -- telemetry --------------------------------------------------------

    def _emit(self, name: str, **fields: Any) -> None:
        if self.recorder is not None:
            self.recorder.record_event(name, **fields)
        if self.statsd is not None:
            from ringpop_tpu_torch.obs.statsd_bridge import CKPT_KEY_MAP

            mapped = CKPT_KEY_MAP.get(name)
            if mapped is not None:
                self.statsd.increment(mapped, 1)

    # -- inventory --------------------------------------------------------

    def path_of(self, tick: int) -> str:
        return os.path.join(self.directory, checkpoint_name(tick))

    def list_checkpoints(self) -> List[Tuple[int, str]]:
        """All ``ckpt-*`` entries, ascending by tick (validity not
        checked here; tmp leftovers and foreign entries are ignored)."""
        out: List[Tuple[int, str]] = []
        for entry in os.listdir(self.directory):
            m = _CKPT_RE.match(entry)
            if m is not None:
                out.append((int(m.group(1)), os.path.join(self.directory, entry)))
        return sorted(out)

    # -- save + rotation --------------------------------------------------

    def save(self, tick: int, states: Any, meta: Optional[dict] = None) -> str:
        """Atomic manifest save at ``tick`` + keep-last-K rotation."""
        sharded = self.spec.sharded_fields
        if sharded is None and self.shards > 1:
            sharded = _dynamic_sharded_fields(states)
        path = self.path_of(tick)
        t0 = self._clock()
        timings: Dict[str, float] = {}
        manifest = ckpt.save_checkpoint(
            path,
            states,
            self.spec.params,
            shards=self.shards,
            sharded_fields=sharded,
            meta=dict(meta or {}, tick=tick),
            timings=timings,
        )
        wall = self._clock() - t0
        self.last_save = dict(timings, tick=tick, nbytes=manifest["nbytes"], wall_s=wall)
        self._emit(
            "ckpt.saved",
            tick=tick,
            path=os.path.basename(path),
            nbytes=manifest["nbytes"],
            shards=self.shards,
            wall_s=wall,
        )
        self.gc()
        return path

    def gc(self) -> List[str]:
        """Delete checkpoints older than the keep-th newest VALID one
        (shallow validity: manifest parses, files exist at exact sizes).
        Corrupt entries newer than that boundary are kept for forensics
        until they age past it."""
        entries = self.list_checkpoints()
        valid_seen = 0
        boundary: Optional[int] = None
        for tick, path in reversed(entries):
            try:
                ckpt.verify_checkpoint(path, deep=False)
            except ckpt.CheckpointError:
                continue
            valid_seen += 1
            if valid_seen >= self.keep:
                boundary = tick
                break
        if boundary is None:
            return []
        removed = []
        for tick, path in entries:
            if tick < boundary:
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
        if removed:
            self._emit("ckpt.gc", removed=[os.path.basename(p) for p in removed], keep=self.keep)
        return removed

    # -- recovery ---------------------------------------------------------

    def restore_latest(self) -> Optional[Tuple[int, Any]]:
        """Newest-first scan: load the first checkpoint that verifies
        clean, falling back past corrupt ones (each recorded in
        ``last_errors`` + emitted as ``ckpt.corrupt``).  Returns
        ``(tick, states)`` (CPU tensors) or None when nothing valid
        exists."""
        self.last_errors = []
        t0 = self._clock()
        for tick, path in reversed(self.list_checkpoints()):
            try:
                states = ckpt.load_checkpoint(path, self.spec.state_cls, self.spec.params)
            except ckpt.CheckpointError as e:
                self.last_errors.append((tick, path, e))
                self._emit(
                    "ckpt.corrupt",
                    tick=tick,
                    path=os.path.basename(path),
                    error=type(e).__name__,
                    message=str(e),
                )
                continue
            self.last_restore = dict(tick=tick, scan_verify_s=self._clock() - t0,
                                     skipped_corrupt=len(self.last_errors))
            self._emit(
                "ckpt.resumed",
                tick=tick,
                path=os.path.basename(path),
                skipped_corrupt=len(self.last_errors),
            )
            return tick, states
        self.last_restore = dict(tick=None, scan_verify_s=self._clock() - t0,
                                 skipped_corrupt=len(self.last_errors))
        return None


def _copy_state(st):
    host = convert.state_arrays(st)
    return type(st)(**host)


def host_copy_states(states: Any) -> Any:
    """Host copies of a state (or dict of states): a NamedTuple of numpy
    arrays per state, in the stored dtypes (uint32 fields as uint32), None
    preserved, every state read in one transfer.  Copies, never views:
    on the CPU ``tensor.numpy()`` shares memory a later in-place tick
    writes."""
    if hasattr(states, "_fields"):
        return _copy_state(states)
    host = convert.states_arrays(states)
    return {name: type(st)(**host[name]) for name, st in states.items()}


def _tree_concat(windows: List[Any]) -> Any:
    first = windows[0]
    if hasattr(first, "_fields"):
        return type(first)(*(_tree_concat([getattr(w, f) for w in windows]) for f in first._fields))
    if isinstance(first, tuple):
        return tuple(_tree_concat([w[i] for w in windows]) for i in range(len(first)))
    return np.concatenate([np.asarray(w) for w in windows], axis=0)


def concat_metrics(windows: List[Any]) -> Any:
    """Concatenate per-window ``[T]``-stacked numpy metrics along the
    time axis (the chunked run's merge; NamedTuples and tuples of
    NamedTuples both work)."""
    if len(windows) == 1:
        return windows[0]
    return _tree_concat(windows)


def states_to(states: Any, device) -> Any:
    """A state (or dict of states) with every tensor moved to ``device``."""
    def move(st):
        return type(st)(*(None if x is None else x.to(device) for x in st))

    if hasattr(states, "_fields"):
        return move(states)
    return {name: move(st) for name, st in states.items()}


class CheckpointableMixin:
    """Cadenced checkpointing for the drivers.

    Subclasses provide ``_ckpt_spec()`` (a :class:`CheckpointSpec`),
    ``_ckpt_states()`` (the current states, tensors on the driver's
    device) and ``_ckpt_install(states)`` (place restored CPU states on
    the device, applying the driver's load fixups).  The mixin owns the
    tick counter, the cadence split of runs and the manager lifecycle."""

    _ckpt_manager: Optional[CheckpointManager] = None
    _ckpt_every: int = 0
    tick_count: int = 0

    # -- subclass hooks ---------------------------------------------------

    def _ckpt_spec(self) -> CheckpointSpec:
        raise NotImplementedError

    def _ckpt_states(self) -> Any:
        raise NotImplementedError

    def _ckpt_install(self, states: Any) -> None:
        raise NotImplementedError

    # -- public surface ---------------------------------------------------

    @property
    def checkpoint_manager(self) -> Optional[CheckpointManager]:
        return self._ckpt_manager

    def enable_checkpoints(
        self,
        directory: str,
        every: int = 0,
        keep: int = 3,
        shards: Optional[int] = None,
        statsd: Any = None,
    ) -> CheckpointManager:
        """Attach a checkpoint family: save every ``every`` driven ticks
        (0 = manual ``checkpoint_now()`` only), keep the last ``keep``
        valid checkpoints, split node-axis fields over ``shards`` files
        (default 1).  Events ride the already-attached run recorder,
        counters the optional statsd client."""
        if every < 0:
            raise ValueError("every must be >= 0, got %d" % every)
        self._ckpt_manager = CheckpointManager(
            directory,
            self._ckpt_spec(),
            keep=keep,
            shards=self._default_ckpt_shards() if shards is None else shards,
            recorder=getattr(self, "recorder", None),
            statsd=statsd,
        )
        self._ckpt_every = every
        return self._ckpt_manager

    def _default_ckpt_shards(self) -> int:
        return 1

    def checkpoint_now(self) -> str:
        """Force a save at the current tick count."""
        if self._ckpt_manager is None:
            raise ValueError("checkpointing is off — call enable_checkpoints() first")
        return self._ckpt_manager.save(self.tick_count, self._ckpt_states())

    def restore_latest(self) -> Optional[int]:
        """Resume from the newest valid checkpoint: install its states on
        the driver's device, set the tick counter, return the resumed tick
        (None = nothing valid found; the driver keeps its fresh state, the
        clean-restart half of the recovery contract).  The manager's
        ``last_restore`` gets the scan's and the install's seconds."""
        mgr = self._ckpt_manager
        if mgr is None:
            raise ValueError("checkpointing is off — call enable_checkpoints() first")
        got = mgr.restore_latest()
        if got is None:
            return None
        tick, states = got
        t0 = time.perf_counter()
        self._ckpt_install(states)
        dev = getattr(self, "device", None)
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mgr.last_restore["install_s"] = time.perf_counter() - t0
        self.tick_count = tick
        return tick

    # -- cadence plumbing -------------------------------------------------

    def _after_ticks(self, k: int) -> None:
        """Advance the driven-tick counter; save when the cadence line
        is crossed (chunked runs land exactly ON it by construction)."""
        self.tick_count += k
        if (
            self._ckpt_manager is not None
            and self._ckpt_every > 0
            and self.tick_count % self._ckpt_every == 0
            and k > 0
        ):
            self.checkpoint_now()

    def _run_chunked(self, schedule, run_window):
        """Split ``run_window(schedule)`` at checkpoint-cadence lines;
        trajectory- and metrics-bitwise-neutral (a run of T ticks is the
        composition of its windows)."""
        total = schedule.ticks
        if self._ckpt_manager is None or self._ckpt_every <= 0 or total == 0:
            out = run_window(schedule)
            self._after_ticks(total)
            return out
        windows = []
        t = 0
        while t < total:
            # stop at the next cadence line (tick_count-aligned, so a run()
            # resumed mid-interval still saves on the grid)
            step = self._ckpt_every - (self.tick_count % self._ckpt_every)
            t1 = min(total, t + step)
            windows.append(run_window(schedule.window(t, t1)))
            self._after_ticks(t1 - t)
            t = t1
        return concat_metrics(windows)
