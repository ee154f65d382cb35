"""The ``overflow`` prong: interval-range overflow and index certification
of every registered entry point.

Counterpart of ``ringpop_tpu/analysis/overflow.py``.  The interval
interpreter of :mod:`.ranges` runs over each entry's recording (the graph
prong's registry and cache, recorded with ``detail``) and every new way a
value range can escape its dtype under the declared scale contracts is a
finding.  Three rules, as JAX's:

``dtype-overflow``
    an op whose integer result escapes its dtype from in-range inputs, and
    a ``sum``/``cumsum`` re-priced at the entry's declared N;
``unbounded-carry``
    a signed state field whose interval, widened from each tick's output
    back into its input until stable, escapes its dtype: a per-tick-growing
    counter, named by its field path (``SimState.tick_index``);
``index-overflow``
    an int32 index lane (``arange``, ``gather``/``index_select``/``index``/
    ``take``/``scatter*``) whose indexed extent exceeds it at the declared
    N, or an index value carried into a narrower integer (a
    ``.to(torch.int32)`` of an int64 ``searchsorted``, an int32 flat offset).

The launch-side half of ``index-overflow`` is ``ops/_build.py``: a kernel's
integer argument outside int32 raises before the launch.

The triaged findings on the tree are :data:`ALLOWED`, each with its
reason; a full run reports a row that suppressed nothing, and a
:data:`~.ranges.WRAP_CONTRACT` row that silenced no escape, as
``stale-allowlist``, so both tables shrink with the code they excuse.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ringpop_tpu_torch.analysis import ranges
from ringpop_tpu_torch.analysis.findings import Finding

PRONG = "overflow"


@dataclasses.dataclass(frozen=True)
class AllowRow:
    """One triaged finding class: ``entries``/``keys`` are patterns where
    ``*`` is the only metacharacter; an event is suppressed when an entry
    pattern matches the entry name and a key pattern ``"rule:key"``."""

    entries: Tuple[str, ...]
    keys: Tuple[str, ...]
    why: str


# The certifier's findings on the tree, triaged: JAX's classes (tick
# stamps, incarnations, perm_inv, obs planes, scalable stamps, the packed
# key, telemetry sums) by their port entries, and the port's own.
# tests/test_torch_analysis_overflow.py pins the table against a full run
# and its fields against JAX's ALLOWED.
_FULL = ("engine-tick*", "batched-tick", "fuzz-scan-full")
ALLOWED: Tuple[AllowRow, ...] = (
    AllowRow(
        entries=_FULL,
        keys=("unbounded-carry:SimState.tick_index", "unbounded-carry:SimState.susp_deadline"),
        why=(
            "int32 tick counter and tick-derived deadline: wraps at 2^31 ticks = 13.6 "
            "years of 200 ms protocol periods, four orders past the 2^20-tick (~2.4 "
            "day) serving envelope — documented headroom, not a live hazard (JAX's row)"
        ),
    ),
    AllowRow(
        entries=_FULL,
        keys=(
            "unbounded-carry:SimState.inc",
            "unbounded-carry:SimState.ch_inc",
            "unbounded-carry:SimState.ch_source_inc",
            "unbounded-carry:SimState.ch_pb",
        ),
        why=(
            "incarnation stamps (and the change table's stamp and budget planes) mint "
            "from the tick index: bounded by ticks + 2 < 2^21 per engine._pack_key's "
            "invariant; the interval domain cannot see the mint-site bound through the "
            "carry (JAX's row)"
        ),
    ),
    AllowRow(
        entries=_FULL,
        keys=("unbounded-carry:SimState.perm_inv",),
        why=(
            "the inverse membership permutation: values in [0, N) by construction; the "
            "carry interval is polluted through the affine reshuffle's select chains, "
            "not by arithmetic growth of the permutation (JAX's row)"
        ),
    ),
    AllowRow(
        entries=_FULL + ("engine-scalable-*", "route-tick-reqtrace"),
        keys=(
            "unbounded-carry:SimState.ev_buf",
            "unbounded-carry:SimState.ev_drops",
            "unbounded-carry:SimState.first_heard",
            "unbounded-carry:ScalableState.first_heard",
            "unbounded-carry:RouteState.req_buf",
            "unbounded-carry:RouteState.req_tick",
            "unbounded-carry:RouteState.req_drops",
            "unbounded-carry:RouteState.req_counts",
        ),
        why=(
            "obs-only planes (flight-recorder words and drop counter, wavefront "
            "stamps, request-trace records, ticks, drops and counts): tick-stamped "
            "or counting by design and proven unable to reach the trajectory by the "
            "noninterference prong — a wrap distorts telemetry only (JAX's row; the "
            "request planes show here because the port's carry fixpoint covers one-"
            "tick entries)"
        ),
    ),
    AllowRow(
        entries=("engine-scalable-*", "fuzz-scan-scalable"),
        keys=(
            "unbounded-carry:ScalableState.tick_index",
            "unbounded-carry:ScalableState.susp_since",
            "unbounded-carry:ScalableState.truth_inc",
            "unbounded-carry:ScalableState.r_birth",
        ),
        why=(
            "scalable-engine int32 tick stamps: suspicion start, ground-truth "
            "incarnation and rumor birth mint from tick_index and share its 2^31 "
            "wrap horizon (13.6 years at 200 ms) against the 2^20-tick serving "
            "envelope; int64 would double the O(N)/O(U) planes for no contract gain "
            "(JAX's row)"
        ),
    ),
    AllowRow(
        entries=("route-tick-*",),
        keys=(
            "unbounded-carry:RouteState.ring.first_owner",
            "unbounded-carry:RouteState.ring.next_owner",
        ),
        why=(
            "the bucketed ring's owners are the low word of a packed int64 key (hash "
            "<< 32 | member), in [0, N) by construction; the interval domain sees the "
            "low word of a full-range int64 and widens the carry, no arithmetic grows "
            "it (the perm_inv class)"
        ),
    ),
    AllowRow(
        entries=_FULL,
        keys=("dtype-overflow:mul@models/sim/engine.py:_pack_key",
              "dtype-overflow:mul@ops/ping_req.py:_pack_key"),
        why=(
            "engine._pack_key (and its copy in the ping-req legs) computes inc * 4 + "
            "status in int32 under the invariant stamps < ticks + 2 (the packed key "
            "stays < 2^22); the flagged range inherits the widened inc carry, the "
            "mint-site bound holds (JAX's row)"
        ),
    ),
    AllowRow(
        entries=_FULL + ("fused-apply-*", "fused-piggyback-*"),
        keys=(
            "dtype-overflow:sum.scaled@ops/fused_apply.py:apply_updates_plain",
            "dtype-overflow:sum.scaled@ops/fused_piggyback.py:pb_budget_plain",
            "dtype-overflow:sum.scaled@models/sim/engine.py:*",
        ),
        why=(
            "int32 telemetry sums over [N, N] masks (applied count, piggyback drops, "
            "ping-req and full-sync counts): the worst case assumes all N^2 pairs fire "
            "in one tick, real multiplicity is <= N * K; metrics only, and exact at "
            "the sizes the bitwise gates compare (JAX's row)"
        ),
    ),
    AllowRow(
        entries=("engine-scalable-tick-mesh*",),
        keys=("dtype-overflow:mul@parallel/mesh.py:_route_rows_stats",),
        why=(
            "dpos = dest - floor(dest / local) * local: the product never exceeds the "
            "destination it was divided from (an int32 global row id < N), but the "
            "interval domain does not see the quotient's correlation with its dividend"
        ),
    ),
)


@functools.lru_cache(maxsize=None)
def _pat(p: str):
    """Glob where ``*`` is the only metacharacter (keys hold literal
    brackets and dots)."""
    return re.compile("".join(".*" if c == "*" else re.escape(c) for c in p) + r"\Z")


def _match(value: str, patterns: Sequence[str]) -> bool:
    return any(_pat(p).match(value) for p in patterns)


def allowed(entry: str, rule: str, key: str,
            allowlist: Optional[Sequence[AllowRow]] = None) -> Optional[int]:
    """Index of the first allowlist row suppressing this event, else None."""
    allowlist = ALLOWED if allowlist is None else allowlist
    tag = f"{rule}:{key}"
    for i, row in enumerate(allowlist):
        if _match(entry, row.entries) and _match(tag, row.keys):
            return i
    return None


def _finding(rule: str, path: str, message: str) -> Finding:
    return Finding(rule=rule, path=path, line=0, message=message, prong=PRONG)


def _event_finding(name: str, ev: ranges.RangeEvent) -> Finding:
    return _finding(
        ev.rule, f"<entry:{name}>",
        f"{ev.key}: {ev.detail} — fix the dtype, tighten the declared contract in "
        "ranges.ENTRY_SCALES, or triage into overflow.ALLOWED with a reason")


def check_recording(name: str, recording, args, spec: Optional[ranges.ScaleSpec] = None,
                    allowlist: Optional[Sequence[AllowRow]] = None,
                    wrap: Optional[Dict[str, str]] = None
                    ) -> Tuple[List[Finding], set, set]:
    """Certify one detailed recording; returns (findings, used allowlist
    rows, used wrap-contract rows).  ``allowlist``/``wrap`` default to
    :data:`ALLOWED` and :data:`~.ranges.WRAP_CONTRACT`."""
    allowlist = ALLOWED if allowlist is None else allowlist
    in_names, out_names = ranges.leaf_names(recording, args)
    events, wraps = ranges.analyze(recording, spec or ranges.entry_scale(name), in_names,
                                   out_names, wrap=wrap)
    findings: List[Finding] = []
    used: set = set()
    for ev in sorted(events, key=lambda e: (e.rule, e.key)):
        row = allowed(name, ev.rule, ev.key, allowlist)
        if row is None:
            findings.append(_event_finding(name, ev))
        else:
            used.add(row)
    return findings, used, wraps


def check_entry(name: str, fn, args: Tuple, spec: Optional[ranges.ScaleSpec] = None,
                allowlist: Optional[Sequence[AllowRow]] = None,
                wrap: Optional[Dict[str, str]] = None) -> Tuple[List[Finding], set]:
    """Certify one ad-hoc entry (recorded afresh, as the mutation tests'
    doctored ones are); returns (findings, used allowlist rows)."""
    from ringpop_tpu_torch.analysis import graph_audit as ga

    try:
        r = ga.record_entry(name, fn, args, detail=True)
    except Exception as e:
        return [ga.trace_failure(name, e, PRONG)], set()
    findings, used, _ = check_recording(name, r.recording, r.args, spec, allowlist, wrap)
    return findings, used


def check_overflow(entry_names: Optional[Sequence[str]] = None,
                   allowlist: Optional[Sequence[AllowRow]] = None,
                   wrap: Optional[Dict[str, str]] = None) -> List[Finding]:
    """The prong over the graph prong's registry (or ``entry_names``).  A
    run over every entry also reports the :data:`ALLOWED` and
    :data:`~.ranges.WRAP_CONTRACT` rows that suppressed nothing."""
    from ringpop_tpu_torch.analysis import graph_audit as ga

    allowlist = ALLOWED if allowlist is None else allowlist
    wrap = ranges.WRAP_CONTRACT if wrap is None else wrap
    full = entry_names is None
    names = [ep.name for ep in ga.DEFAULT_ENTRIES] if full else list(entry_names)
    findings: List[Finding] = []
    used_all: set = set()
    wraps_all: set = set()
    for name in names:
        ep = ga.ENTRIES_BY_NAME.get(name)
        if ep is None:
            findings.append(_finding("trace-failure", f"<entry:{name}>", "unknown entry point"))
            continue
        try:
            r = ga.recorded(ep, detail=True)
        except Exception as e:
            findings.append(ga.trace_failure(name, e, PRONG))
            continue
        got, used, wraps = check_recording(name, r.recording, r.args, None, allowlist, wrap)
        findings.extend(got)
        used_all |= used
        wraps_all |= wraps
    if full:
        for i, row in enumerate(allowlist):
            if i not in used_all:
                findings.append(_finding(
                    "stale-allowlist", "ringpop_tpu_torch/analysis/overflow.py",
                    f"ALLOWED[{i}] ({row.keys[0]}, ...) suppressed nothing in a full run — "
                    "the finding it excuses is gone; delete the row"))
        for pat in sorted(set(wrap) - wraps_all):
            findings.append(_finding(
                "stale-allowlist", "ringpop_tpu_torch/analysis/ranges.py",
                f"WRAP_CONTRACT row {pat!r} silenced no escape in a full run — no op there "
                "wraps any more; delete the row"))
    return findings


# --changed-only scoping: every entry records code from these trees
SOURCES: Tuple[str, ...] = ("analysis/", "models/", "ops/", "parallel/", "fuzz/")


def entries_for_changed(rel_paths: Iterable[str]) -> List[str]:
    """Entry names to re-certify for changed package-relative paths; an
    empty list skips the prong."""
    from ringpop_tpu_torch.analysis import graph_audit as ga

    if any(r.startswith(SOURCES) for r in rel_paths):
        return [ep.name for ep in ga.DEFAULT_ENTRIES]
    return []
