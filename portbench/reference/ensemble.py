"""The reference of the full engine's ensemble.

Two kinds of numbers decide ``correct``.  The first kind judges what the
program produced against the guarantees the configuration states, with
code written for the benchmark alone (it shares nothing with the
program's): membership checksums rebuilt from each view as the Node
reference builds them (:mod:`.checksum`, :mod:`.farmhash`), member.js's
update precedence and the suspect-to-faulty timing per view over the
window's last chunk, and the plan's liveness and clock.  The second kind
follows the program's trajectory with a frozen copy of its own plain
engine (``frozen/``): a regression twin, which catches a kernel that
departs from its plain version in a way no guarantee above can see.

:class:`RefEnsemble` steps B clusters of the frozen engine together under
``torch.func.vmap`` (seeds ``seed .. seed + B - 1``, straight-line, every
kernel site on its plain PyTorch version), with the fast commutative
checksum in place of FarmHash32.  The protocol reads a checksum only to
test two of them for equality (a ping's advertised checksum against the
receiver's, and the count of distinct checksums), so from the same state
the fast checksum drives the same transitions as FarmHash32 unless two
different views collide in one of the two 32-bit hashes; the FarmHash32
values themselves are judged apart, row by row (``checksum_mismatch``).

The comparison (:func:`judge`) has these numbers, each with the limit 0:

- ``checksum_mismatch``: rows of the program's state at the window's
  start and end whose checksum is not FarmHash32 of the row's Node
  checksum string (every row of every cluster);
- ``precedence_violations``: over the last chunk, (cluster, viewer,
  member) entries of viewers up and joined through the chunk whose
  ``(incarnation, status)`` moved down member.js's order (alive < suspect
  < faulty < leave at one incarnation; a higher incarnation above all) or
  that forgot a member; at the window's start and end, entries holding an
  incarnation of a member newer than the member's own;
- ``suspicion_violations``: at the end of the last chunk, entries of those
  viewers that are suspect with a deadline outside the next
  ``suspicion_ticks`` ticks (a suspect older than that must be faulty),
  suspect at the chunk's start and end at one incarnation with a deadline
  that moved, or not suspect with a deadline; self entries that are
  suspect or faulty (the refute);
- ``plan_mismatch``: clusters whose clock is not the plan's at the end,
  and nodes whose liveness differs from the plan's;
- ``start_mismatch``: the reference's own set-up (init from the seeds,
  bootstrap, the converge ticks) against the program's state at the
  window's start, every trajectory field but the checksum and the record
  cache;
- ``window_mismatch``: from the program's state at the start of the
  window's last chunk, the reference steps that chunk; every trajectory
  field of the end state but the checksum and the record cache, and every
  per-tick metric of the chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import checksum as cs
from portbench.reference.common import count_differing, total, worst
from portbench.reference.frozen.models.sim import engine as E

# what the fast checksum cannot reproduce: the checksum values and the
# FarmHash32 record cache; a metric that counts the farmhash recompute
NOT_FOLLOWED = frozenset({"checksum", "rec_bytes", "rec_len"})
STATE_FIELDS = tuple(f for f in E.SimState._fields
                     if f in E.SIM_TRAJECTORY_FIELDS and f not in NOT_FOLLOWED)
METRIC_FIELDS = E.TickMetrics._fields


def vmap_tick(step, state, inputs):
    """One tick of ``step(state, inputs)`` for B stacked states; the
    inputs are shared.  Fields that are None ride outside the map."""
    present = tuple(f for f in state._fields if getattr(state, f) is not None)
    absent = {f: None for f in state._fields if getattr(state, f) is None}

    def body(tensors, inp):
        new, metrics = step(type(state)(**absent, **dict(zip(present, tensors))), inp)
        return tuple(getattr(new, f) for f in present), tuple(metrics)

    in_inputs = type(inputs)(*(None for _ in inputs))
    tensors, metrics = torch.func.vmap(body, in_dims=(0, in_inputs))(
        tuple(getattr(state, f) for f in present), inputs)
    return state._replace(**dict(zip(present, tensors))), E.TickMetrics(*metrics)


class RefEnsemble:
    """B clusters of the frozen engine on ``device``, stepped together."""

    def __init__(self, b: int, n: int, engine_params: dict, seed: int, device):
        self.b, self.n = b, n
        self.device = torch.device(device)
        # the fast checksum reads no addresses
        self.universe = None
        knobs = dict(engine_params, n=n, checksum_mode="fast", fused_checksum="off",
                     fused_tick="plain", hash_impl="plain", gate_phases=False,
                     parity_recompute="full")
        self.params = E.SimParams(**knobs)
        states = [E.init_state(self.params, seed=seed + i, universe=self.universe,
                               device=self.device) for i in range(b)]
        self.state = type(states[0])(*(
            None if getattr(states[0], f) is None else torch.stack([getattr(s, f) for s in states])
            for f in states[0]._fields))

    def adopt(self, program_state) -> None:
        """Take the program's state (step by step from it), every row's
        checksum recomputed with the fast hash: a row the tick leaves clean
        keeps its checksum, so FarmHash32 values beside fast ones would
        make equal views look different."""
        state = E.SimState(**{
            f: (None if f in ("rec_bytes", "rec_len") else getattr(program_state, f, None))
            for f in E.SimState._fields})
        fast = [E.compute_checksums(E.SimState(*(None if x is None or x.dim() == 0 else x[i]
                                                 for x in state)), self.universe, self.params)
                for i in range(self.b)]
        self.state = state._replace(checksum=torch.stack(fast))

    def _tick(self, inputs):
        self.state, m = vmap_tick(
            lambda s, i: E.tick(s, i, self.params, self.universe), self.state, inputs)
        return m

    def bootstrap(self) -> None:
        inputs = E.TickInputs.quiet(self.n, self.device)._replace(
            join=torch.ones(self.n, dtype=torch.bool, device=self.device))
        self._tick(inputs)

    def run(self, kill: np.ndarray, revive: np.ndarray) -> E.TickMetrics:
        """Step a [T, N] kill / revive plan; metrics come back [T, B] numpy."""
        k = torch.as_tensor(kill, dtype=torch.bool, device=self.device)
        r = torch.as_tensor(revive, dtype=torch.bool, device=self.device)
        quiet = E.TickInputs.quiet(self.n, self.device)
        rows = [self._tick(quiet._replace(kill=k[t], revive=r[t])) for t in range(k.shape[0])]
        return E.TickMetrics(*(torch.stack([getattr(m, f) for m in rows]).to("cpu").numpy()
                               for f in E.TickMetrics._fields))


# the engine's status codes, in member.js's order at one incarnation
ALIVE, SUSPECT, FAULTY, LEAVE = 0, 1, 2, 3


def checksum_mismatch(state, n: int, epoch_ms: int, period_ms: int) -> int:
    """Rows of a ``[B, N, N]`` state whose checksum is not FarmHash32 of
    the row's Node checksum string."""
    known, status, inc = (x.reshape(-1, n) for x in (state.known, state.status, state.inc))
    want = cs.view_checksums(cs.addresses(n), known, status,
                             cs.stamp_to_ms(inc, epoch_ms, period_ms))
    got = state.checksum.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    return int((want != got).sum())


def _self(x: torch.Tensor) -> torch.Tensor:
    """[B, N] self entries of a [B, N, N] plane."""
    return x.diagonal(dim1=-2, dim2=-1)


def incarnation_ceiling(state) -> int:
    """Entries holding an incarnation of a member newer than the member's
    own (its self entry): no view may invent an incarnation."""
    return int((state.known & (state.inc > _self(state.inc)[:, None, :])).sum())


def precedence_violations(start, end, stable: torch.Tensor) -> int:
    """Entries of ``stable`` [B, N] viewers that forgot a member or whose
    ``(incarnation, status)`` fell in member.js's order between ``start``
    and ``end``."""
    rank_s = start.inc.to(torch.int64) * 4 + start.status
    rank_e = end.inc.to(torch.int64) * 4 + end.status
    bad = (start.known & ~end.known) | (start.known & end.known & (rank_e < rank_s))
    return int((bad & stable[..., None]).sum())


def suspicion_violations(start, end, stable: torch.Tensor, t_end: int,
                         suspicion_ticks: int) -> int:
    """The suspect-to-faulty timing of ``stable`` [B, N] viewers at the
    end of a chunk whose last tick is ``t_end``."""
    n = end.status.shape[-1]
    self_ = torch.eye(n, dtype=torch.bool, device=end.status.device)
    susp = end.known & (end.status == SUSPECT) & ~self_
    dl = end.susp_deadline
    early_or_stale = susp & ((dl <= t_end) | (dl > t_end + suspicion_ticks))
    stray = ~susp & (dl != -1)
    held = (start.known & (start.status == SUSPECT) & susp & (start.inc == end.inc)
            & (dl != start.susp_deadline))
    unrefuted = self_ & ((end.status == SUSPECT) | (end.status == FAULTY))
    bad = early_or_stale | stray | held | unrefuted
    return int((bad & stable[..., None]).sum())


def plan_mismatch(end, down: np.ndarray, t_end: int) -> int:
    """Clusters whose clock is not ``t_end`` and nodes whose liveness is
    not the plan's (``down``: [N] bool held down)."""
    up = torch.as_tensor(~down, device=end.proc_alive.device)
    clocks = int((end.tick_index.reshape(-1) != t_end).sum())
    return clocks + int((end.proc_alive != up).sum())


def judge(*, b: int, n: int, engine_params: dict, seed: int, device, converge_ticks: int,
          plan, start_state, last_chunk: int, last_start, end_state, last_metrics,
          log=None) -> list:
    """The numbers of the module docstring, as ``(name, value, limit)``.
    ``plan`` is a fresh :class:`~portbench.lib.traffic.ChurnPlan` of the
    run's mix and seed; ``start_state`` is the program's state at the
    window's start, ``last_start`` / ``end_state`` at the start and end of
    chunk ``last_chunk`` (the window's last), whose metrics are
    ``last_metrics``."""
    epoch_ms, period_ms = int(engine_params["epoch_ms"]), int(engine_params["period_ms"])
    sums = (checksum_mismatch(start_state, n, epoch_ms, period_ms)
            + checksum_mismatch(end_state, n, epoch_ms, period_ms))

    ref = RefEnsemble(b, n, engine_params, seed, device)
    ref.bootstrap()
    quiet = np.zeros((converge_ticks, n), bool)
    ref.run(quiet, quiet)
    start = count_differing(start_state, ref.state, STATE_FIELDS)
    # the clock at the window's start, from the reference's own set-up
    t_window = int(ref.state.tick_index.reshape(-1)[0])

    kill, revive = plan.chunk(last_chunk)
    ref.adopt(last_start)
    metrics = ref.run(kill, revive)
    window = count_differing(end_state, ref.state, STATE_FIELDS)
    window.update(count_differing(last_metrics, metrics, METRIC_FIELDS))
    del ref

    t_end = t_window + plan.chunk_ticks * (last_chunk + 1)
    down_before = (plan.down_after(last_chunk - 1) if last_chunk > 0
                   else np.zeros(n, bool))
    steady = torch.as_tensor(~down_before & ~kill.any(0) & ~revive.any(0), device=device)
    stable = steady[None, :] & last_start.ready & last_start.gossip_on
    precedence = (precedence_violations(last_start, end_state, stable)
                  + incarnation_ceiling(start_state) + incarnation_ceiling(end_state))
    suspicion = suspicion_violations(last_start, end_state, stable, t_end,
                                     int(engine_params["suspicion_ticks"]))
    planned = plan_mismatch(end_state, plan.down_after(last_chunk), t_end)
    if log is not None:
        log("start differs in: %s; window differs in: %s" % (worst(start), worst(window)))
    return [("checksum_mismatch", sums, 0), ("precedence_violations", precedence, 0),
            ("suspicion_violations", suspicion, 0), ("plan_mismatch", planned, 0),
            ("start_mismatch", total(start), 0), ("window_mismatch", total(window), 0)]
