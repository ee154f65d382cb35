"""The reference of the scalable engine's storm.

Two kinds of numbers decide ``correct``.  The first kind judges what the
program produced against the guarantees the configuration states, with
code written for the benchmark alone (:mod:`.mix`): every node's
checksum recomputed from the state, the rumour deltas held against the
truth, the ring digest rebuilt from the truth, and the plan's clock,
liveness and rejoins.  The second kind follows the program's trajectory
with a frozen copy of its own plain engine (``frozen/``): a regression
twin, which catches a kernel that departs from its plain version in a
way no guarantee above can see.

:class:`RefStorm` steps the frozen scalable engine (``fused_exchange=
"plain"``: the exchange as plain PyTorch ops) through the same kill /
revive plan; as the control it also stands in for the program.

The comparison (:func:`judge`) has these numbers, each with the limit 0:

- ``checksum_mismatch``: at the window's start and end, nodes whose
  checksum is not ``base_sum`` plus the deltas of the active rumours the
  node heard (the recompute the incremental checksum must equal), plus one
  for each of the two states where ``base_sum`` plus every active delta
  is not the checksum of the truth (every node at its truth status and
  incarnation): what a node that heard everything holds;
- ``ring_mismatch``: ring digests of the program (at the window's start
  and after its last cycle) that differ from the digest of the ring of
  the nodes alive and suspect in the truth (on_membership_event.js:106-134);
- ``plan_mismatch``: after the last cycle, a clock that is not the
  plan's, nodes whose liveness is not the plan's, and nodes the cycle
  killed and revived whose truth incarnation did not advance (a revived
  node rejoins with a new incarnation);
- ``start_mismatch``: the twin's own set-up (init from the seed, the warm
  cycles) against the program's state at the window's start, every
  state field;
- ``window_mismatch``: from the program's state at the start of the
  window's last cycle, the twin steps that cycle; every state field of
  the end state and every per-tick metric of the cycle.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import mix
from portbench.reference.common import count_differing, total, worst
from portbench.reference.frozen.models.sim import engine_scalable as ES

ALIVE, SUSPECT = 0, 1


class RefStorm:
    """One scalable cluster of the frozen engine on ``device``."""

    def __init__(self, n: int, engine_params: dict, seed: int, device, replica_points: int):
        self.device = torch.device(device)
        params = ES.ScalableParams(**dict(engine_params, n=n, fused_exchange="plain"))
        self.params = ES.resolve_scalable_params(params, self.device.type)
        self.state = ES.init_state(self.params, seed=seed, device=self.device)
        self.replica_points = replica_points

    def adopt(self, program_state) -> None:
        """Take the program's state (step by step from it)."""
        self.state = ES.ScalableState(**{f: getattr(program_state, f, None)
                                         for f in ES.ScalableState._fields})

    def run(self, kill: np.ndarray, revive: np.ndarray) -> ES.ScalableMetrics:
        """Step a [T, N] kill / revive plan; metrics come back [T] numpy."""
        k = torch.as_tensor(kill, dtype=torch.bool, device=self.device)
        r = torch.as_tensor(revive, dtype=torch.bool, device=self.device)
        rows = []
        for t in range(k.shape[0]):
            self.state, m = ES.tick(self.state, ES.ChurnInputs(kill=k[t], revive=r[t]), self.params)
            rows.append(m)
        return ES.ScalableMetrics(*(torch.stack(f).to("cpu").numpy() for f in zip(*rows)))

    def ring_digest(self) -> int:
        return ring_digest(self.state, self.replica_points)


def ring_digest(state, replica_points: int) -> int:
    return mix.ring_digest(state.proc_alive & (state.truth_status <= SUSPECT), replica_points)


def heard_sums(state, rows: int = 1 << 16) -> torch.Tensor:
    """[N] int64: ``base_sum`` plus the deltas of the active rumours each
    node heard, mod 2^32 (bit ``r % 32`` of word ``r // 32`` of a node's
    ``heard`` row is rumour slot ``r``)."""
    dev = state.heard.device
    delta = torch.where(state.r_active, state.r_delta.to(torch.int64) & mix.M32, 0)
    shifts = torch.arange(32, device=dev)
    out = []
    for r0 in range(0, state.heard.shape[0], rows):
        words = state.heard[r0:r0 + rows].to(torch.int64)
        bits = ((words[:, :, None] >> shifts) & 1).reshape(words.shape[0], -1)
        out.append((bits * delta[None, :]).sum(1))
    base = int(state.base_sum) & mix.M32
    return (torch.cat(out) + base) & mix.M32


def checksum_mismatch(state) -> int:
    got = state.checksum.to(torch.int64) & mix.M32
    nodes = int((heard_sums(state) != got).sum())
    everything = (int(state.base_sum)
                  + int(torch.where(state.r_active, state.r_delta.to(torch.int64) & mix.M32, 0)
                        .sum())) & mix.M32
    return nodes + int(everything != mix.truth_sum(state.truth_status, state.truth_inc))


def plan_mismatch(start, end, plan, cycle: int, t_end: int) -> int:
    """The plan's clock, liveness and rejoins after cycle ``cycle``."""
    kill, revive = plan.chunk(cycle)
    up = torch.as_tensor(~plan.down_after(cycle), device=end.proc_alive.device)
    rejoined = torch.as_tensor(kill.any(0) & revive.any(0), device=end.proc_alive.device)
    stale = rejoined & (end.truth_inc <= start.truth_inc)
    return (int(int(end.tick_index) != t_end) + int((end.proc_alive != up).sum())
            + int(stale.sum()))


def judge(*, n: int, engine_params: dict, replica_points: int, seed: int, device, plan,
          warm_cycles: int, start_state, start_digest: int, last_chunk: int, last_start,
          end_state, last_metrics, end_digest: int, log=None) -> list:
    """The numbers of the module docstring, as ``(name, value, limit)``.
    ``plan`` is a fresh :class:`~portbench.lib.traffic.ChurnPlan` of the
    run's mix and seed; ``warm_cycles`` cycles ran in set-up."""
    sums = checksum_mismatch(start_state) + checksum_mismatch(end_state)
    rings = (int(ring_digest(start_state, replica_points) != start_digest)
             + int(ring_digest(end_state, replica_points) != end_digest))
    not_alive = int((end_state.truth_status != ALIVE).sum())

    ref = RefStorm(n, engine_params, seed, device, replica_points)
    for c in range(warm_cycles):
        ref.run(*plan.chunk(c))
    start = count_differing(start_state, ref.state, ES.ScalableState._fields)
    t_window = int(ref.state.tick_index)

    ref.adopt(last_start)
    metrics = ref.run(*plan.chunk(last_chunk))
    window = count_differing(end_state, ref.state, ES.ScalableState._fields)
    window.update(count_differing(last_metrics, metrics, ES.ScalableMetrics._fields))
    del ref

    t_end = t_window + plan.chunk_ticks * (last_chunk + 1 - warm_cycles)
    planned = plan_mismatch(last_start, end_state, plan, last_chunk, t_end)
    if log is not None:
        log("start differs in: %s; window differs in: %s; nodes not alive in the truth "
            "at the end: %d" % (worst(start), worst(window), not_alive))
    return [("checksum_mismatch", sums, 0), ("ring_mismatch", rings, 0),
            ("plan_mismatch", planned, 0), ("start_mismatch", total(start), 0),
            ("window_mismatch", total(window), 0)]
