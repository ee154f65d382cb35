"""The reference of the lossy quiet cluster: the network's loss rate and
SWIM's suspicion and refute rules.

Written apart from the program, in plain PyTorch over the state fields
and per-tick metrics the storm's reference reads (:mod:`.storm`).  Three
exact counts, each with the limit 0, judge the window's last cycle:

- ``loss_violations``: ticks whose lost direct probes (``pings_sent`` -
  ``pings_delivered``) lie outside ``loss * sent +- 6 sigma``, with
  ``sigma = sqrt(sent * loss * (1 - loss))``.  In a quiet, unpartitioned
  cluster only the network's loss fails a direct probe, each one
  independently (a probe of a node's own row is lost at the same rate),
  so the count is binomial; a tick falls outside 6 sigma about once in
  5e8.  The storm's twin proves the metrics equal to the frozen engine's.
- ``refute_violations``: nodes up through the cycle that the truth held
  suspect or faulty at its start and holds alive at its end at an
  incarnation no newer than the start's.  Under member.js's precedence
  (member.js:76-81) alive beats suspect or faulty only at a higher
  incarnation: a refute mints a fresh one.
- ``suspicion_violations``: at the cycle's end, live nodes holding a
  suspicion clock past its deadline (suspicion.js:111-113).  The tick
  convention, from the engine: a clock started in tick ``t`` holds
  ``susp_since = t`` and expires in the tick whose index is ``t +
  suspicion_ticks`` (the expiry phase runs after the suspect phase of
  the same tick), so after any tick ``T`` every live node's clock has
  ``T - susp_since <= suspicion_ticks - 1``.

Logged beside them, with no limit: the nodes the truth holds faulty while
their process is up at the end, and the false suspicions and refutes the
program published over the window, per 60 ticks.
"""

from __future__ import annotations

import math

import torch

ALIVE, SUSPECT, FAULTY = 0, 1, 2
SIGMAS = 6.0


def loss_violations(pings_sent, pings_delivered, loss: float) -> int:
    """Ticks whose lost direct probes fall outside the binomial band."""
    sent = torch.as_tensor(pings_sent, dtype=torch.float64)
    lost = sent - torch.as_tensor(pings_delivered, dtype=torch.float64)
    sigma = torch.sqrt(sent * loss * (1.0 - loss))
    return int(((lost - loss * sent).abs() > SIGMAS * sigma).sum())


def refute_violations(start, end, up) -> int:
    """Refutes at an incarnation that is not newer (``up``: [N] bool, the
    nodes up through the cycle)."""
    defamed = (start.truth_status == SUSPECT) | (start.truth_status == FAULTY)
    stale = up & defamed & (end.truth_status == ALIVE) & (end.truth_inc <= start.truth_inc)
    return int(stale.sum())


def suspicion_violations(end, suspicion_ticks: int) -> int:
    """Live nodes whose suspicion clock outlived its deadline."""
    since = end.susp_since.to(torch.int64)
    late = end.proc_alive & (since >= 0) & (int(end.tick_index) - since >= suspicion_ticks)
    return int(late.sum())


def judge(*, engine_params: dict, start, end, up, metrics, totals: dict, log=None) -> list:
    """The numbers of the module docstring, as ``(name, value, limit)``,
    over the cycle from state ``start`` to state ``end`` with its per-tick
    ``metrics`` (numpy, or tensors); ``totals`` holds the window's
    ``ticks``, ``suspects`` and ``refutes``, for the log."""
    loss = float(engine_params["packet_loss"])
    lost = loss_violations(metrics.pings_sent, metrics.pings_delivered, loss)
    refuted = refute_violations(start, end, up)
    late = suspicion_violations(end, int(engine_params["suspicion_ticks"]))
    if log is not None:
        faulty_up = int(((end.truth_status == FAULTY) & end.proc_alive).sum())
        per = 60.0 / totals["ticks"] if totals.get("ticks") else math.nan
        sent = float(sum(int(x) for x in metrics.pings_sent))
        got = float(sum(int(x) for x in metrics.pings_delivered))
        log("lossy cluster: direct probes lost %.4f%% over the last cycle; faulty while up at "
            "the end: %d; defamed at the cycle's start: %d; over the window (%d ticks) %d false "
            "suspects and %d refutes, %.1f and %.1f per 60 ticks"
            % (100.0 * (sent - got) / max(sent, 1.0), faulty_up,
               int(((start.truth_status == SUSPECT) | (start.truth_status == FAULTY)).sum()),
               totals.get("ticks", 0), totals.get("suspects", 0), totals.get("refutes", 0),
               per * totals.get("suspects", 0), per * totals.get("refutes", 0)))
    return [("loss_violations", lost, 0), ("refute_violations", refuted, 0),
            ("suspicion_violations", late, 0)]
