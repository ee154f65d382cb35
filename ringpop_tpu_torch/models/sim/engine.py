"""The batched SWIM protocol period — one gossip tick for N nodes at once.

Counterpart of ``ringpop_tpu/models/sim/engine.py``: ``tick(state, inputs,
params, universe) -> (state, metrics)`` over dense ``[N, N]`` observer
planes, phases 0-9 in the reference's order (join -> ping send -> receiver
apply -> responses incl. full-sync -> sender apply -> ping-req -> suspicion
expiry -> checksums).  The module docstring of the JAX engine documents the
discrete-time model, the deviation envelope and the cited reference
behaviour; this port reproduces that program bit for bit
(tests/test_torch_engine.py compares every state and metric field per
tick).

What the port runs, by knob (``SimParams``):

- ``fused_tick``: "kernel"/"plain" route the six membership-update sites
  through :func:`ringpop_tpu_torch.ops.fused_apply.apply_updates` and the
  four piggyback-budget sites through
  :func:`ringpop_tpu_torch.ops.fused_piggyback.pb_budget` (CUDA kernels,
  or their plain versions); "off" is the classic phase-by-phase tick
  (``_apply_updates`` plus the caller-side deadline stamp, the budgets
  inline), the JAX engine's "off" program;
- ``fused_checksum`` (farmhash mode): "on" is the fused record-cache
  pipeline (``_fused_checksums_where``, hashing rows with the
  :func:`ringpop_tpu_torch.ops.stream_hash.fused_stream` kernel); "off" is
  the classic ``membership_rows`` + ``hash32_rows`` recompute, whose
  long-string block loop is the
  :func:`ringpop_tpu_torch.ops.block_loop.block_loop` kernel, in the
  "full", "bounded" and "gated" shapes of ``parity_recompute``;
- ``hash_impl``: "kernel" or "plain" for both hash kernels
  (``fused_stream`` and ``block_loop``).

"auto" means the kernels on the card and the plain versions on the CPU.

The tick is one shard's body, :func:`shard_tick`: a generator over the
shard's observer rows that yields every read of another shard's rows as a
collective; :func:`tick` runs it as one shard holding every row, and
``parallel.mesh.ShardedSim`` runs S of them in lockstep.  Every kernel
works on whole rows, so a shard launches each on its own rows.

The obs planes, off by default and trajectory-neutral (written after every
protocol phase from the masks that drove it; nothing in the protocol reads
them, and they add no host read): ``flight_recorder`` appends event
records and stamps the first-heard matrix (:mod:`.flight`), and
``histograms`` bumps the log2 counters of :data:`HIST_TRACKS`
(:mod:`ringpop_tpu_torch.ops.histogram`).  Either one makes every fused
site return its dense applied mask (``want_masks``).  On a mesh the
first-heard matrix is node-leading like the views, the event buffer is
cut into capacity blocks (:mod:`.flight`), and every shard holds the
whole counters: its bumps over its own rows are summed across the shards,
and the whole cluster's ``dirty_rows`` is recorded once.

uint32 values (``rng``, ``checksum``) are int32 bit patterns (ops/u32.py).
Nothing here updates a state tensor in place: every phase builds new
tensors, so views taken earlier in the tick keep their values.
"""

from __future__ import annotations

import math
import types
from typing import NamedTuple, Optional

import numpy as np
import torch

from ringpop_tpu_torch.obs import perf
from ringpop_tpu_torch.ops import checksum_encode as ce
from ringpop_tpu_torch.ops import farmhash as fh
from ringpop_tpu_torch.ops import fused_apply as fap
from ringpop_tpu_torch.ops import fused_checksum as fc
from ringpop_tpu_torch.ops import fused_piggyback as fpb
from ringpop_tpu_torch.ops import histogram as hg
from ringpop_tpu_torch.ops import ping_req as prk
from ringpop_tpu_torch.ops import toolkit
from ringpop_tpu_torch.ops import u32
from ringpop_tpu_torch.ops.record_mix import record_mix
from ringpop_tpu_torch.models.sim import flight
from ringpop_tpu_torch.models.sim.engine_scalable import Solo, _agreed, run_solo

# status codes (== ce.STATUS_*): rank order IS override priority at equal
# incarnation: alive < suspect < faulty < leave
ALIVE, SUSPECT, FAULTY, LEAVE = 0, 1, 2, 3

NO_TARGET = -1
INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1

# SimState.hist rows, in order (the JAX engine's HIST_TRACKS; units are
# ticks): rumor age at adoption (gossip adoptions landing ALIVE, age =
# tick + 1 - incarnation stamp), rumor age at piggyback retirement,
# suspicion duration at timer stop (revive resets excluded), and the
# tick's dirty-row count.
HIST_TRACKS = ("rumor_age", "retired_age", "suspicion_duration", "dirty_rows")


class SimParams(NamedTuple):
    """Static protocol constants and knobs (field names as in the JAX
    engine; see its SimParams for each one's meaning).

    Port knob values: ``fused_tick`` takes "auto" | "kernel" | "plain" |
    "off" and picks the CUDA kernels of the apply and budget sites, their
    plain PyTorch versions, or the classic tick; ``hash_impl`` takes "auto"
    | "kernel" | "plain" for the two hash kernels (``fused_stream`` and
    ``block_loop``) — "auto" = the kernels on the card, the plain versions
    on the CPU; ``fused_checksum`` takes "auto" | "on" | "off" ("on"
    needs farmhash mode; "auto" = "on" in farmhash mode, "off" in fast
    mode); ``parity_recompute`` takes "auto", "gated", "bounded" or
    "full"."""

    n: int
    period_ms: int = 200  # gossip/index.js:194-196
    epoch_ms: int = 1414142122274
    suspicion_ticks: int = 25  # 5000 ms / 200 ms — suspicion.js:111-113
    ping_req_size: int = 3  # index.js:113
    join_size: int = 3  # join-sender.js:52
    piggyback_factor: int = 15  # dissemination.js:180
    max_digits: int = 14  # incarnation digit bound (ms epoch timestamps)
    packet_loss: float = 0.0
    dirty_batch: int = 256
    checksum_mode: str = "farmhash"
    parity_recompute: str = "auto"
    fused_checksum: str = "auto"
    cell_batch: int = 16384
    gate_phases: bool = True
    fused_tick: str = "auto"
    hash_impl: str = "auto"
    # the obs planes (module docstring); event_capacity is the flight
    # recorder's buffer in records (overflow drops and counts new events)
    flight_recorder: bool = False
    event_capacity: int = 65536
    histograms: bool = False


class SimState(NamedTuple):
    """Per-node views + protocol state (field names as in the JAX engine)."""

    tick_index: torch.Tensor  # [] int32
    proc_alive: torch.Tensor  # [N] bool
    ready: torch.Tensor  # [N] bool
    gossip_on: torch.Tensor  # [N] bool
    partition: torch.Tensor  # [N] int32
    known: torch.Tensor  # [N, N] bool
    status: torch.Tensor  # [N, N] int32
    inc: torch.Tensor  # [N, N] int32 stamp
    ch_active: torch.Tensor  # [N, N] bool
    ch_status: torch.Tensor  # [N, N] int32
    ch_inc: torch.Tensor  # [N, N] int32 stamp
    ch_source: torch.Tensor  # [N, N] int32
    ch_source_inc: torch.Tensor  # [N, N] int32 stamp
    ch_pb: torch.Tensor  # [N, N] int32
    susp_deadline: torch.Tensor  # [N, N] int32 (-1 inactive)
    perm_inv: torch.Tensor  # [N, N] int32
    iter_pos: torch.Tensor  # [N] int32
    rng: torch.Tensor  # [N, 2] int32 (uint32 keys)
    checksum: torch.Tensor  # [N] int32 (uint32 checksums)
    rec_bytes: Optional[torch.Tensor] = None  # [N, N, R] uint8 (farmhash)
    rec_len: Optional[torch.Tensor] = None  # [N, N] int32 (farmhash)
    # flight-recorder plane (flight_recorder only; layout obs/events.py)
    ev_buf: Optional[torch.Tensor] = None  # [event_capacity, 8] int32
    ev_head: Optional[torch.Tensor] = None  # [] int32 — valid records
    ev_drops: Optional[torch.Tensor] = None  # [] int32 — overflow count
    first_heard: Optional[torch.Tensor] = None  # [N, N] int32
    # latency-histogram plane (histograms only): [len(HIST_TRACKS),
    # NBUCKETS] int32 (uint32 counters)
    hist: Optional[torch.Tensor] = None


# Every SimState field is either trajectory (protocol state, compared
# bitwise between the engines) or obs-only (a write-only telemetry plane
# the trajectory never reads); the sets are the JAX engine's
# (``SIM_OBS_ONLY_FIELDS`` / ``SIM_TRAJECTORY_FIELDS``), spelled out so a
# new field must be placed in one.  ``fuzz.executor.split_obs`` drains the
# obs-only planes by these names.
SIM_OBS_ONLY_FIELDS = frozenset({"ev_buf", "ev_head", "ev_drops", "first_heard", "hist"})
SIM_TRAJECTORY_FIELDS = frozenset({
    "tick_index", "proc_alive", "ready", "gossip_on", "partition", "known", "status",
    "inc", "ch_active", "ch_status", "ch_inc", "ch_source", "ch_source_inc", "ch_pb",
    "susp_deadline", "perm_inv", "iter_pos", "rng", "checksum", "rec_bytes", "rec_len",
})
# the fields the JAX engine holds as uint32, kept here as int32 bit
# patterns (ops/u32.py): their arithmetic wraps mod 2^32 by contract, and
# the range prongs seed them full range (analysis/ranges.py)
SIM_UINT32_FIELDS = frozenset({"rng", "checksum", "hist"})


class TickInputs(NamedTuple):
    """Per-tick event-schedule inputs (the fault-injection plane)."""

    kill: torch.Tensor  # [N] bool
    revive: torch.Tensor  # [N] bool
    join: torch.Tensor  # [N] bool
    partition: torch.Tensor  # [N] int32 — -1 keeps current
    resume: Optional[torch.Tensor] = None  # [N] bool SIGCONT
    leave: Optional[torch.Tensor] = None  # [N] bool graceful leave

    @staticmethod
    def quiet(n: int, device="cpu") -> "TickInputs":
        z = torch.zeros(n, dtype=torch.bool, device=device)
        return TickInputs(
            kill=z,
            revive=z,
            join=z,
            partition=torch.full((n,), -1, dtype=torch.int32, device=device),
        )


class TickMetrics(NamedTuple):
    pings_sent: torch.Tensor
    pings_delivered: torch.Tensor
    ping_reqs: torch.Tensor
    full_syncs: torch.Tensor
    changes_applied: torch.Tensor
    suspects_marked: torch.Tensor
    faulties_marked: torch.Tensor
    distinct_checksums: torch.Tensor
    converged: torch.Tensor  # bool
    parity_overflow: torch.Tensor
    refutes: torch.Tensor
    piggyback_drops: torch.Tensor
    full_sync_records: torch.Tensor
    ping_req_inconclusive: torch.Tensor
    join_merges: torch.Tensor
    dirty_rows: torch.Tensor


# ---------------------------------------------------------------------------
# knob resolution


def check_ported(params: SimParams) -> None:
    """Validate the checksum and recompute knobs."""
    if params.checksum_mode not in ("fast", "farmhash"):
        raise ValueError("checksum_mode must be fast|farmhash, got %r" % (params.checksum_mode,))
    resolve_fused_checksum(params)
    if params.parity_recompute not in ("auto", "gated", "bounded", "full"):
        raise ValueError(
            "parity_recompute must be auto|gated|bounded|full, got %r" % (params.parity_recompute,)
        )


def resolve_fused_tick(params: SimParams, device_type: str) -> str:
    """"kernel" (the CUDA kernels), "plain" (their PyTorch versions) or
    "off" (the classic tick)."""
    impl = toolkit.resolve_impl(
        "fused_tick", params.fused_tick, device_type,
        auto={"cuda": "kernel", "*": "plain"},
        allowed=("kernel", "plain", "off"),
    )
    if impl == "kernel" and device_type != "cuda":
        raise ValueError("fused_tick='kernel' needs a CUDA device (the kernels run on the card)")
    return impl


def resolve_sharded_fused_tick(params: SimParams, device_type: str) -> str:
    """What JAX's ``ShardedSim`` runs for ``fused_tick``, in the port's
    terms (JAX's ``resolve_sharded_fused_tick`` through
    ``convert.FUSED_TICK_MAP``): a ``pallas_call`` does not partition under
    GSPMD, so JAX drops the kernels ("kernel", its "pallas") to the plain
    twin ("plain", its "xla") on a mesh; "plain" and "off" are honoured.
    The port's own pick on a mesh is :func:`resolve_fused_tick`'s: every
    kernel of the tick works on whole rows, so each shard launches it on
    its own (``parallel.mesh.ShardedSim``)."""
    if params.fused_tick == "kernel":
        return "plain"
    resolved = resolve_fused_tick(params, device_type)
    return "plain" if resolved == "kernel" else resolved


def _ping_req_kernels(ft: str, sh, n: int) -> bool:
    """Whether the ping-req phase launches ``ops/ping_req.py``'s kernels:
    with the tick's kernels (``ft`` "kernel", :func:`resolve_fused_tick`)
    on one shard holding every row.  A mesh runs the phase's legs
    (``ops/ping_req.py``'s plain legs) with collectives between its
    shards, the CPU as plain ops."""
    return ft == "kernel" and sh.rows == n


def resolve_hash_impl(params: SimParams, device_type: str) -> str:
    """The two hash kernels (``fused_stream``, ``block_loop``): "kernel" or
    "plain" — the counterpart of the JAX engine's ``hash_impl`` knob."""
    impl = toolkit.resolve_impl(
        "hash_impl", params.hash_impl, device_type,
        auto={"cuda": "kernel", "*": "plain"},
        allowed=("kernel", "plain"),
    )
    if impl == "kernel" and device_type != "cuda":
        raise ValueError("hash_impl='kernel' needs a CUDA device (the kernels run on the card)")
    return impl


def resolve_fused_checksum(params: SimParams) -> str:
    """"on" (the fused record-cache pipeline) or "off" (the classic
    ``membership_rows`` + ``hash32_rows`` recompute).  "auto" is "on" in
    farmhash mode on every device — the fused pipeline is the port's
    production shape, as it is the JAX engine's on the TPU — and "off" in
    fast mode; "on" needs farmhash mode."""
    if params.fused_checksum == "on" and params.checksum_mode != "farmhash":
        raise ValueError(
            "fused_checksum='on' requires checksum_mode='farmhash' "
            "(fast mode has no checksum strings to fuse)"
        )
    return toolkit.resolve_impl(
        "fused_checksum", params.fused_checksum, "*",
        auto={"*": "on" if params.checksum_mode == "farmhash" else "off"},
        allowed=("on", "off"),
    )


def resolve_parity_recompute() -> str:
    """The exact unfused recompute shape — every dirty row covered, no
    overflow possible: "gated", the JAX engine's non-TPU row (a Python loop
    over K-row chunks here, one host read of the dirty count per call).
    The overflow replays' shape and ``_checksums_where``'s "auto"."""
    return "gated"


def resolve_exact_recompute(params: SimParams) -> str:
    """The exact recompute shape for overflow replays: "full" for fused
    runs (the fused pipeline's only exact shape), else
    :func:`resolve_parity_recompute`."""
    if resolve_fused_checksum(params) == "on":
        return "full"
    return resolve_parity_recompute()


def resolve_auto_parity(params: SimParams, device_type: str) -> SimParams:
    """Cluster-level resolution (SimCluster construction), as the JAX
    engine's ``resolve_auto_parity``: concrete ``fused_tick`` and
    ``fused_checksum``; ``parity_recompute="auto"`` becomes "bounded" with
    ``dirty_batch = min(n, 1024)`` on the fused pipeline (at n <= 1024 the
    row chunk covers every row, so only cell overflow can replay) and
    "gated" otherwise (JAX's non-TPU row)."""
    check_ported(params)
    params = params._replace(
        fused_tick=resolve_fused_tick(params, device_type),
        fused_checksum=resolve_fused_checksum(params),
    )
    if params.parity_recompute == "auto":
        if params.fused_checksum == "on":
            params = params._replace(parity_recompute="bounded", dirty_batch=min(params.n, 1024))
        else:
            params = params._replace(parity_recompute="gated")
    return params


# ---------------------------------------------------------------------------
# small helpers


def stamp_to_ms(stamp: torch.Tensor, params: SimParams) -> torch.Tensor:
    """int32 incarnation stamp -> the reference's int64 epoch-ms value
    (stamp 0 = never asserted, encodes as 0)."""
    ms = params.epoch_ms + (stamp.to(torch.int64) - 1) * params.period_ms
    return torch.where(stamp > 0, ms, torch.zeros_like(ms))


def _pack_key(inc, status):
    """Winner-combine key: lexicographic (incarnation stamp, status-rank)."""
    return inc.to(torch.int32) * 4 + status.to(torch.int32)


def _max_piggyback(server_count: torch.Tensor, factor: int) -> torch.Tensor:
    """15 * ceil(log10(n + 1)) via integer digit count (dissemination.js:41)."""
    count = torch.zeros(server_count.shape, dtype=torch.int32, device=server_count.device)
    for k in range(10):  # server counts < 10^10
        count = count + (server_count >= 10**k).to(torch.int32)
    return factor * count


_COPRIME_CACHE: dict = {}


def _coprimes_of(n: int, k: int = 128):
    """(coprimes, modular inverses): up to ``k`` integers coprime to ``n``,
    spread evenly over [1, n), plus their inverses mod n."""
    got = _COPRIME_CACHE.get((n, k))
    if got is None:
        if n >= 46341:
            raise ValueError("affine reshuffle index math needs n*n < 2^31")
        cops = [a for a in range(1, n) if math.gcd(a, n) == 1]
        step = max(1, -(-len(cops) // k))
        chosen = cops[::step][:k]
        got = (
            np.asarray(chosen, np.int32),
            np.asarray([pow(a, -1, n) for a in chosen], np.int32),
        )
        _COPRIME_CACHE[(n, k)] = got
    return got


_COPRIME_INVS: dict = {}


def _coprime_invs_on(n: int, device) -> torch.Tensor:
    """``_coprimes_of(n)``'s inverses on ``device``, uploaded once per
    device: an upload inside a tick is a synchronous copy on the card."""
    got = _COPRIME_INVS.get((n, device))
    if got is None:
        got = _COPRIME_INVS[(n, device)] = torch.as_tensor(_coprimes_of(n)[1], device=device)
    return got


def _fold(rng: torch.Tensor, salt: int) -> torch.Tensor:
    """Cheap per-node key derivation: [N, 2] -> new [N, 2] (uint32 words)."""
    k0 = rng[:, 0] * u32.s32(0x9E3779B9) + u32.s32(salt)
    k1 = rng[:, 1] ^ ((k0 << 13) | u32.srl(k0, 19))
    k1 = k1 * u32.s32(0x85EBCA6B) + 1
    return torch.stack([k1, k0 ^ k1], dim=1)


def _uniform(rng: torch.Tensor, shape, salt: int) -> torch.Tensor:
    """[N, ...] float32 uniforms in [0, 1) derived per node (row i from
    rng[i]); the uint32 -> float32 cast rounds like numpy's."""
    n = rng.shape[0]
    cols = math.prod(shape) // n
    base = rng[:, 0]
    j = torch.arange(cols, dtype=torch.int32, device=rng.device)
    x = base[:, None] + j[None, :] * u32.s32(0x01000193) + u32.s32(salt)
    x = x ^ u32.srl(x, 15)
    x = x * u32.s32(0x2C1B3C6D)
    x = x ^ u32.srl(x, 12)
    x = x * u32.s32(0x297A2D39)
    x = x ^ u32.srl(x, 15)
    return (u32.to_f32(x) / float(2**32)).reshape(shape)


def _smallest_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of each row's ``k`` smallest scores, lower index first
    among ties — ``lax.top_k(-score, k)``'s order (a stable sort, since
    ``torch.topk`` promises no tie order)."""
    return torch.argsort(score, dim=1, stable=True)[:, :k]


def _segment_sum(values, seg, n):
    out = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    return out.index_add(0, seg.to(torch.int64), values)[:n]


def _nonzero_static(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` on a flat mask:
    the first ``size`` set positions in order, then ``fill`` — a cumsum
    compaction with no host sync."""
    flat = mask.reshape(-1)
    rank = torch.cumsum(flat.to(torch.int64), 0) - 1
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    tgt = torch.where(flat & (rank < size), rank, size)
    out = out.index_put((tgt,), torch.arange(flat.numel(), dtype=torch.int64, device=mask.device))
    return out[:size]


def _scatter_rows_drop(base: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(values, mode="drop")`` where out-of-range targets
    are exactly ``len(base)``."""
    pad = torch.zeros((1,) + tuple(base.shape[1:]), dtype=base.dtype, device=base.device)
    ext = torch.cat([base, pad])
    return ext.index_put((idx.to(torch.int64),), values)[: base.shape[0]]


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# state construction and checksums


def init_state(
    params: SimParams,
    seed: int = 0,
    universe: Optional[ce.Universe] = None,
    device="cpu",
) -> SimState:
    """Every node knows only itself (alive, incarnation = epoch) — the same
    numpy draws as the JAX ``init_state``, so both engines seed one state."""
    check_ported(params)
    if params.checksum_mode == "farmhash" and universe is None:
        raise ValueError(
            "farmhash checksum mode needs the universe at init_state to "
            "seed the dirty-row checksum cache (pass universe=...)"
        )
    dev = torch.device(device)
    n = params.n
    eye = np.eye(n, dtype=bool)
    inc0 = np.where(eye, 1, 0).astype(np.int32)
    rng = np.random.default_rng(seed)
    perm = np.stack([rng.permutation(n) for _ in range(n)]).astype(np.int32)
    perm_inv = np.argsort(perm, axis=1).astype(np.int32)
    keys = rng.integers(1, 2**32 - 1, size=(n, 2), dtype=np.uint32)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    state = SimState(
        tick_index=t(0, torch.int32),
        proc_alive=torch.ones(n, dtype=torch.bool, device=dev),
        ready=_zeros(n, torch.bool, dev),
        gossip_on=torch.ones(n, dtype=torch.bool, device=dev),
        partition=_zeros(n, torch.int32, dev),
        known=t(eye, torch.bool),
        status=_zeros((n, n), torch.int32, dev),
        inc=t(inc0, torch.int32),
        ch_active=_zeros((n, n), torch.bool, dev),
        ch_status=_zeros((n, n), torch.int32, dev),
        ch_inc=_zeros((n, n), torch.int32, dev),
        ch_source=torch.full((n, n), -1, dtype=torch.int32, device=dev),
        ch_source_inc=_zeros((n, n), torch.int32, dev),
        ch_pb=_zeros((n, n), torch.int32, dev),
        susp_deadline=torch.full((n, n), -1, dtype=torch.int32, device=dev),
        perm_inv=t(perm_inv, torch.int32),
        iter_pos=_zeros(n, torch.int32, dev),
        rng=u32.from_numpy(keys, dev),
        checksum=_zeros(n, torch.int32, dev),
    )
    # the fused pipeline's record cache: a pure function of (known,
    # status, inc), seeded with every row's self-view records
    if resolve_fused_checksum(params) == "on":
        rec_b, rec_l = fc.member_records(
            universe, state.known, state.status, stamp_to_ms(state.inc, params),
            params.max_digits,
        )
        state = state._replace(rec_bytes=rec_b, rec_len=rec_l)
    if params.flight_recorder:
        buf, head, drops, first_heard = flight.init_recorder_fields(
            n, params.event_capacity, dev
        )
        state = state._replace(ev_buf=buf, ev_head=head, ev_drops=drops, first_heard=first_heard)
    if params.histograms:
        state = state._replace(hist=hg.init(len(HIST_TRACKS), dev))
    return state._replace(checksum=compute_checksums(state, universe, params))


def compute_checksums(state: SimState, universe: ce.Universe, params: SimParams):
    """Every row's checksum from scratch ([R] int32 uint32 patterns, one a
    row of the ``[R, N]`` views: the whole cluster or a shard's rows); in
    farmhash mode the classic composition ``hash32_rows(*membership_rows(...))``,
    the reference's own definition of a membership checksum."""
    if params.checksum_mode == "fast":
        n = state.known.shape[1]
        subject = torch.arange(n, dtype=torch.int32, device=state.known.device)[None, :]
        rec = record_mix(subject, state.status, state.inc)
        return u32.row_sum(torch.where(state.known, rec, 0), dim=1)
    return _hash_rows(state.known, state.status, state.inc, universe, params)


def _count_hashed(lens: torch.Tensor, per_row: int = 1) -> None:
    """Add the rows handed to the row hash (``per_row`` elements of
    ``lens`` a row), every vmapped cluster included, to the span log's
    ``rows_hashed``: read from shapes, no device read."""
    if perf.active() is not None:
        perf.count("rows_hashed", toolkit.unbatched(lens).numel() // per_row)


def _hash_rows(known, status, inc, universe, params):
    """FarmHash32 of the checksum strings of the given view rows."""
    with perf.span("checksum.encode"):
        bufs, lens = ce.membership_rows(
            universe, known, status, stamp_to_ms(inc, params), max_digits=params.max_digits
        )
    with perf.span("checksum.hash"):
        _count_hashed(lens)
        return fh.hash32_rows(bufs, lens, impl=resolve_hash_impl(params, known.device.type))


def _rank(sh, count):
    """Where this shard's rows stand in the whole cluster's row order (a
    shard body's generator): for a local count (a [] int32), the count of
    the shards before this one and the whole cluster's.  One shard holding
    every row gets ``(None, count)`` and no collective."""
    if sh.shards == 1:
        return None, count
    every = yield ("gather", count[None])  # [S]
    return every[:sh.index].sum(dtype=torch.int32), every.sum(dtype=torch.int32)


def _quota(count, before, budget: int):
    """How many of this shard's first ``count`` rows (or cells) fall in the
    whole cluster's first ``budget``: all of them when one shard holds
    every row (``before`` None)."""
    if before is None:
        return count
    return torch.minimum(count, (budget - before).clamp(min=0))


def _checksums_where(sh, state, universe, params, dirty, cached, changed):
    """Per-row checksum with dirty-row caching (a shard body's generator):
    returns ``(checksum [R], overflow [] int32, state)`` for the shard's
    rows.  A row's checksum changes only when its view changed, so clean
    rows keep ``cached``.  Fast mode rehashes only when a row is dirty (a
    clean row's recompute reproduces its cached sum); farmhash mode runs
    the fused record-cache pipeline when ``fused_checksum`` is "on" (and
    the tick tracked the changed cells), else the classic recompute in the
    ``parity_recompute`` shape:

    - "full": every row, straight-line (a clean row reproduces its value);
    - "bounded": ONE K-row chunk (``dirty_batch``) of the whole cluster's
      first K dirty rows; more dirty rows overflow (the count is returned)
      and the cluster replays under an exact shape;
    - "gated" (and "auto"): K-row chunks over every dirty row, a Python
      loop that costs one host read of the dirty counts per call.

    The chunks and the overflow count are the whole cluster's: a shard
    hashes its rows of each chunk, so every shard count gives the same
    checksums and overflow."""
    if resolve_fused_checksum(params) == "on" and changed is not None:
        return (yield from _fused_checksums_where(sh, state, universe, params, dirty, cached,
                                                  changed))
    no_overflow = torch.zeros((), dtype=torch.int32, device=cached.device)
    gate = params.gate_phases
    if params.checksum_mode == "fast":
        n_dirty = dirty.sum(dtype=torch.int32)
        if (yield from _agreed(gate, n_dirty > 0)):
            out = torch.where(dirty, compute_checksums(state, universe, params), cached)
        else:
            out = cached
        return out, no_overflow, state

    n, rows = params.n, sh.rows
    shape = params.parity_recompute
    if shape == "auto":
        shape = resolve_parity_recompute()
    if shape == "full":
        return compute_checksums(state, universe, params), no_overflow, state
    n_dirty = dirty.sum(dtype=torch.int32)
    k = min(params.dirty_batch, n)
    kl = min(k, rows)
    lanes = torch.arange(kl, dtype=torch.int32, device=cached.device)
    if shape == "bounded":
        before, total = yield from _rank(sh, n_dirty)
        if (yield from _agreed(gate, total > 0)):
            idx = _nonzero_static(dirty, kl, 0)
            fresh = _hash_rows(state.known[idx], state.status[idx], state.inc[idx],
                               universe, params)
            tgt = torch.where(lanes < _quota(n_dirty, before, k), idx, rows)
            out = _scatter_rows_drop(cached, tgt, fresh)
        else:
            out = cached
        return out, (total - k).clamp(min=0), state
    if shape != "gated":
        raise ValueError("parity_recompute must be auto|gated|bounded|full, got %r" % (shape,))

    # chunk c covers the whole cluster's dirty rows of rank [cK, cK + K);
    # this shard holds ranks [before, before + mine); a chunk's padded lanes
    # target the dropped slot R
    counts = yield ("counts", n_dirty)
    before, nd, mine = sum(counts[:sh.index]), sum(counts), counts[sh.index]
    rank = torch.cumsum(dirty.to(torch.int32), 0, dtype=torch.int64) - 1
    out = cached
    for c0 in range(0, nd, k):
        a = max(c0, before) - before
        b = min(c0 + k, before + mine) - before
        if a >= b:
            continue
        sel = dirty & (rank >= a) & (rank < b)
        idx = _nonzero_static(sel, kl, 0)
        fresh = _hash_rows(state.known[idx], state.status[idx], state.inc[idx], universe, params)
        tgt = torch.where(lanes < b - a, idx, rows)
        out = _scatter_rows_drop(out, tgt, fresh)
    return out, no_overflow, state


def _fused_checksums_where(sh, state, universe, params, dirty, cached, changed):
    """Fused-pipeline recompute (a shard body's generator): bounded
    changed-cell re-encode into the record cache, then the dirty rows
    hashed by the stream kernel.  Shapes: "bounded" (one cell chunk + one
    row chunk of the whole cluster; more than ``cell_batch`` changed cells
    or ``dirty_batch`` dirty rows overflow and the cluster replays) or
    "full" (dense re-encode of every cell, the exact replay shape; "auto"
    and "gated" mean "full" here, as in the JAX engine)."""
    n, rows = params.n, sh.rows
    dev = cached.device
    i32 = torch.int32
    r = fc.record_width(universe, params.max_digits)
    impl = resolve_hash_impl(params, dev.type)
    no_overflow = torch.zeros((), dtype=i32, device=dev)
    if state.rec_bytes is None:
        raise ValueError(
            "farmhash mode needs the record cache: build the state with "
            "init_state(params, universe=...)"
        )
    shape = params.parity_recompute
    if shape in ("auto", "gated"):
        shape = "full"  # the fused pipeline's only exact shape
    if shape == "full":
        with perf.span("checksum.encode"):
            rec_b, rec_l = fc.member_records(
                universe, state.known, state.status, stamp_to_ms(state.inc, params),
                params.max_digits,
            )
            words = fc.pack_record_words(rec_b)
        with perf.span("checksum.hash"):
            _count_hashed(rec_l, n)
            fresh = fc.fused_hash_rows(words, rec_l, impl=impl)
        return fresh, no_overflow, state._replace(rec_bytes=rec_b, rec_len=rec_l)
    if shape != "bounded":
        raise ValueError("parity_recompute must be auto|bounded|full, got %r" % (shape,))

    n_dirty = dirty.sum(dtype=i32)
    k = min(params.dirty_batch, n)
    kl = min(k, rows)
    cbatch = min(params.cell_batch, n * n)
    cells = rows * n
    cbl = min(cbatch, cells)
    before, total = yield from _rank(sh, n_dirty)

    def update_and_hash():
        # 1. re-encode the shard's share of the whole cluster's first
        # cell_batch changed cells (row-major, shards in order) into the cache
        flat = changed.reshape(-1)
        n_changed = flat.sum(dtype=i32)
        cbefore, c_total = yield from _rank(sh, n_changed)
        cidx = _nonzero_static(flat, cbl, cells)
        if cbefore is not None:
            lane = torch.arange(cbl, dtype=i32, device=dev)
            cidx = torch.where(lane < _quota(n_changed, cbefore, cbatch), cidx, cells)
        crow = torch.div(cidx, n, rounding_mode="floor").clamp(0, rows - 1)
        ccol = (cidx % n).clamp(0, n - 1)
        with perf.span("checksum.encode"):
            cell_b, cell_l = fc.member_records_at(
                universe,
                ccol,
                state.status[crow, ccol],
                stamp_to_ms(state.inc[crow, ccol], params),
                state.known[crow, ccol],
                params.max_digits,
            )
            rec_b = _scatter_rows_drop(state.rec_bytes.reshape(cells, r), cidx,
                                       cell_b).reshape(rows, n, r)
            rec_l = _scatter_rows_drop(state.rec_len.reshape(cells), cidx,
                                       cell_l).reshape(rows, n)
        cell_over = (c_total - cbatch).clamp(min=0)

        # 2. hash the dirty rows' cached records; k == n hashes every row
        # in natural order (rehashing a clean row is bit-neutral)
        if k == n:
            with perf.span("checksum.hash"):
                _count_hashed(rec_l, n)
                fresh = fc.fused_hash_rows(fc.pack_record_words(rec_b), rec_l, impl=impl)
            return torch.where(dirty, fresh, cached), cell_over, rec_b, rec_l
        idx = _nonzero_static(dirty, kl, 0)
        lane_ok = torch.arange(kl, dtype=i32, device=dev) < _quota(n_dirty, before, k)
        with perf.span("checksum.hash"):
            _count_hashed(idx)
            fresh = fc.fused_hash_rows(fc.pack_record_words(rec_b[idx]), rec_l[idx], impl=impl)
        tgt = torch.where(lane_ok, idx, rows)
        return _scatter_rows_drop(cached, tgt, fresh), cell_over, rec_b, rec_l

    out, cell_over, rec_b, rec_l = yield from _phase(
        params.gate_phases,
        total > 0,
        update_and_hash,
        lambda: (cached, no_overflow, state.rec_bytes, state.rec_len),
    )
    return (
        out,
        (total - k).clamp(min=0) + cell_over,
        state._replace(rec_bytes=rec_b, rec_len=rec_l),
    )


# ---------------------------------------------------------------------------
# update application


def _apply_updates(state, now, recv_mask, u_status, u_inc, u_source, u_source_inc, lo: int = 0):
    """Vectorized Member.evaluateUpdate over (observer, subject) pairs, on
    ``[R, N]`` views of rows ``[lo, lo + R)`` (the whole cluster: ``lo=0``,
    ``R = N``).  Returns ``(state', applied, started, stopped, refuted)``,
    all [R, N] bool: suspicion stops are applied here, starts are returned
    for the caller to stamp with the deadline; refuted are the self-refute
    cells."""
    rows, n = state.known.shape
    ids = torch.arange(n, dtype=torch.int32, device=state.known.device)
    is_self = ids[lo:lo + rows, None] == ids[None, :]
    refute = recv_mask & is_self & ((u_status == SUSPECT) | (u_status == FAULTY))
    eff_status = torch.where(refute, ALIVE, u_status)
    eff_inc = torch.where(refute, now, u_inc)
    new_member = recv_mask & ~state.known
    gate = recv_mask & (
        refute | new_member | fap.overrides(eff_status, eff_inc, state.status, state.inc)
    )
    status = torch.where(gate, eff_status, state.status)
    inc = torch.where(gate, eff_inc, state.inc)
    start_t = gate & (status == SUSPECT) & ~is_self
    stop_t = gate & (status != SUSPECT)
    return (
        state._replace(
            known=state.known | new_member,
            status=status,
            inc=inc,
            ch_active=state.ch_active | gate,
            ch_status=torch.where(gate, status, state.ch_status),
            ch_inc=torch.where(gate, inc, state.ch_inc),
            ch_source=torch.where(gate, u_source, state.ch_source),
            ch_source_inc=torch.where(gate, u_source_inc, state.ch_source_inc),
            ch_pb=torch.where(gate, 0, state.ch_pb),
            susp_deadline=torch.where(stop_t, -1, state.susp_deadline),
        ),
        gate,
        start_t,
        stop_t,
        refute,
    )


def _classic_apply(lo: int, state, *update):
    """:func:`_apply_updates` on rows ``[lo, lo + R)``; the whole cluster's
    call (``lo=0``) keeps the rule's seven-argument form."""
    return _apply_updates(state, *update, lo=lo) if lo else _apply_updates(state, *update)


def _diag(x: torch.Tensor, lo: int) -> torch.Tensor:
    """The self cells of ``[R, N]`` rows ``[lo, lo + R)``: ``x[r, lo + r]``
    (a view; the whole cluster's ``x.diagonal()``)."""
    return x.narrow(1, lo, x.shape[0]).diagonal()


def _apply_site(ft, state, union, recv_mask, u_status, u_inc, u_source, u_source_inc,
                now, deadline, *, want_masks, want_count=False, want_refute=True, lo=0):
    """One membership-update application site on ``[R, N]`` rows ``[lo, lo +
    R)``.  Returns ``(state, union, applied_mask_or_None, applied_rows,
    refute_diag, applied_count)``.

    ``ft == "off"`` is the classic shape: ``_apply_updates`` plus the
    caller-side deadline stamp of new suspicion timers (a no-op at the
    expiry site, whose FAULTY updates never start one); it always returns
    the dense applied mask, leaves ``union`` as it is, and derives the row
    OR and the count from the mask.  Otherwise the fused op runs (its
    kernel or plain version), which folds the stamp in."""
    if ft == "off":
        st2, applied, started, _, refuted = _classic_apply(
            lo, state, now, recv_mask, u_status, u_inc, u_source, u_source_inc
        )
        st2 = st2._replace(susp_deadline=torch.where(started, deadline, st2.susp_deadline))
        return (
            st2,
            union,
            applied,
            applied.any(dim=1),
            _diag(refuted, lo),
            applied.sum(dtype=torch.int32) if want_count else None,
        )
    ast = fap.ApplyState(*(getattr(state, f) for f in fap.ApplyState._fields))
    fn = fap.apply_updates if ft == "kernel" else fap.apply_updates_plain
    out = fn(
        ast,
        recv_mask.contiguous(),
        u_status.contiguous(),
        u_inc.contiguous(),
        u_source.contiguous(),
        u_source_inc.contiguous(),
        now,
        deadline,
        union,
        want_masks=want_masks,
        want_count=want_count,
        want_refute=want_refute,
        lo=lo,
    )
    return (
        state._replace(**out.state._asdict()),
        out.union,
        out.applied,
        out.applied_rows,
        out.refute_diag,
        out.applied_count,
    )


def _budget(ft, active, pb, nbump, max_pb, hits=None, want_content=True):
    fn = fpb.pb_budget if ft == "kernel" else fpb.pb_budget_plain
    return fn(
        active, pb, nbump.contiguous(), max_pb,
        None if hits is None else hits.contiguous(),
        want_content=want_content,
    )


# ---------------------------------------------------------------------------
# the tick


def _phase(gate: bool, pred, true_fn, false_fn, *ops):
    """A gated phase in a shard body (a generator): ``true_fn(*ops)`` if
    the predicate, agreed across the shards, holds, else
    ``false_fn(*ops)``; ungated, ``true_fn`` always runs (its TRUE branch
    is a masked no-op on empty inputs, so both programs agree bit for
    bit).  ``true_fn`` may itself be a shard body generator."""
    if (yield from _agreed(gate, pred)):
        out = true_fn(*ops)
        if isinstance(out, types.GeneratorType):
            out = yield from out
        return out
    return false_fn(*ops)


def _fetch(idx, *planes):
    """Rows ``idx`` (global node ids) of node-leading planes, from the
    shards that hold them (a shard body's generator)."""
    return (yield ("fetch", (idx, planes)))


def tick(
    state: SimState,
    inputs: TickInputs,
    params: SimParams,
    universe: ce.Universe,
) -> tuple:
    """One protocol period for every node: ``(state', TickMetrics)`` — the
    shard body :func:`shard_tick` run as one shard holding every row."""
    return run_solo(shard_tick(Solo(params.n), state, inputs, params, universe))


def shard_tick(sh, state: SimState, inputs: TickInputs, params: SimParams,
               universe: ce.Universe):
    """The tick of one shard (a generator), in the form of
    ``engine_scalable.shard_tick``: ``state`` and ``inputs`` hold the
    shard's rows ``[sh.lo, sh.lo + sh.rows)`` of every node-leading field
    (observer rows of the ``[N, N]`` planes) and the scalar clock.  Every
    read of another shard's rows is a collective the body yields as ``(op,
    payload)``: ``gather`` (an ``[N]`` vector all-gathered), ``fetch``
    (rows of sharded planes by global node id, from their owners),
    ``rs_max``/``rs_min``/``rs_any``/``rs_sum`` (a reduce-scatter: the
    shards' ``[N, ...]`` partials combined, each shard receiving its own
    rows — the segment reductions onto receivers and the writes into other
    nodes' rows), ``sum`` (elementwise across shards, of a tensor or a
    tuple of them), ``pred`` (the agreed predicate of a gated phase) and
    ``counts`` (every shard's count, read on the host once).  Every kernel
    of the tick works on whole rows, so each shard launches it on its own.
    :func:`tick` is one shard holding every node; ``parallel.mesh.
    ShardedSim`` runs S bodies in lockstep.  Returns the shard's ``(state,
    TickMetrics)``; the metrics are whole-cluster values."""
    check_ported(params)
    n = params.n
    rows, lo = sh.rows, sh.lo
    dev = state.known.device
    gate = params.gate_phases
    ft = resolve_fused_tick(params, dev.type)
    ft_on = ft != "off"
    fused = params.checksum_mode == "farmhash" and resolve_fused_checksum(params) == "on"
    # the obs planes and the fused-checksum cell tracker consume dense
    # per-site applied masks; otherwise the fused sites emit only
    # reductions.  The classic sites always produce the dense masks (its
    # metrics sum them).
    want_masks = params.flight_recorder or params.histograms or fused
    dense = want_masks or not ft_on
    i32, b8 = torch.int32, torch.bool
    zero_i = torch.zeros((), dtype=i32, device=dev)
    zeros_n = _zeros(rows, b8, dev)
    now = state.tick_index + 2  # this tick's incarnation stamp
    ids = torch.arange(n, dtype=i32, device=dev)
    node = ids[lo:lo + rows, None]  # the shard's rows' node ids
    subject = ids[None, :]
    is_self = node == subject
    tick_next = state.tick_index + 1
    # tick-start baselines of the obs planes: the recorder's old views and
    # the histograms' suspicion-duration start (deadline - suspicion_ticks)
    prev_known, prev_status, prev_susp = state.known, state.status, state.susp_deadline

    phase = perf.phases()  # one span a phase (obs.perf)
    # ---- phase 0: fault-injection plane -------------------------------
    phase.next("fault")
    proc_alive = (state.proc_alive & ~inputs.kill) | inputs.revive
    if inputs.resume is not None:
        proc_alive = proc_alive | inputs.resume
    partition = torch.where(inputs.partition >= 0, inputs.partition, state.partition)
    rv = inputs.revive & ~state.proc_alive
    state = state._replace(
        proc_alive=proc_alive,
        partition=partition,
        ready=state.ready & ~rv,
        gossip_on=state.gossip_on | rv,
        tick_index=tick_next,
    )
    # every node's liveness and partition, read at subject, target and
    # ping-req member ids (neither changes after phase 0)
    alive_all = yield ("gather", proc_alive)
    partition_all = yield ("gather", partition)

    def _revive_reset(state):
        r = rv[:, None]
        return state._replace(
            known=torch.where(r, is_self, state.known),
            status=torch.where(r, ALIVE, state.status),
            inc=torch.where(r & is_self, now, torch.where(r, 0, state.inc)),
            ch_active=state.ch_active & ~r,
            susp_deadline=torch.where(r, -1, state.susp_deadline),
        )

    state = yield from _phase(gate, rv.any(), _revive_reset, lambda s: s, state)

    # ---- phase 0.5: graceful leave ------------------------------------
    phase.next("leave")
    lv = zeros_n
    if inputs.leave is not None:
        self_status = _diag(state.status, lo)
        lv = inputs.leave & state.proc_alive & state.ready & (self_status != LEAVE)
        lv_mask = lv[:, None] & is_self
        own_inc = _diag(state.inc, lo)[:, None]
        state = state._replace(
            status=torch.where(lv_mask, LEAVE, state.status),
            gossip_on=state.gossip_on & ~lv,
            ch_active=state.ch_active | lv_mask,
            ch_status=torch.where(lv_mask, LEAVE, state.ch_status),
            ch_inc=torch.where(lv_mask, own_inc, state.ch_inc),
            ch_source=torch.where(lv_mask, node, state.ch_source),
            ch_source_inc=torch.where(lv_mask, own_inc, state.ch_source_inc),
            ch_pb=torch.where(lv_mask, 0, state.ch_pb),
        )

    # rejoin of a left node: alive with a fresh incarnation, gossip back on
    rejoin = (
        inputs.join & state.proc_alive & state.ready & (_diag(state.status, lo) == LEAVE)
    )

    def _rejoin_write(state):
        rj = rejoin[:, None] & is_self
        return state._replace(
            status=torch.where(rj, ALIVE, state.status),
            inc=torch.where(rj, now, state.inc),
            gossip_on=state.gossip_on | rejoin,
            ch_active=state.ch_active | rj,
            ch_status=torch.where(rj, ALIVE, state.ch_status),
            ch_inc=torch.where(rj, now, state.ch_inc),
            ch_source=torch.where(rj, node, state.ch_source),
            ch_source_inc=torch.where(rj, now, state.ch_source_inc),
            ch_pb=torch.where(rj, 0, state.ch_pb),
        )

    state = yield from _phase(gate, rejoin.any(), _rejoin_write, lambda s: s, state)

    # ---- phase 1: join/bootstrap --------------------------------------
    phase.next("join")
    joiner = (inputs.join | rv) & state.proc_alive & ~state.ready
    # packed [R, ceil(N/32)] applied-cells accumulator (toolkit layout)
    union0 = _zeros((rows, toolkit.packed_width(n)), i32, dev) if ft_on else None

    def _join_phase(state):
        can_join = (
            joiner[:, None]
            & alive_all[None, :]
            & ~is_self
            & (partition[:, None] == partition_all[None, :])
        )
        jrand = _uniform(state.rng, (rows, n), salt=101)
        jscore = torch.where(can_join, jrand, 2.0)
        jorder = _smallest_k(jscore, params.join_size)
        jvalid = torch.gather(jscore, 1, jorder) < 1.5
        known_j, status_j, inc_j = state.known, state.status, state.inc
        for k in range(params.join_size):
            tgt = jorder[:, k]
            ok = jvalid[:, k] & joiner
            t_known, t_status, t_inc = yield from _fetch(tgt, state.known, state.status,
                                                          state.inc)
            take = ok[:, None] & t_known
            better = take & (
                ~known_j | (_pack_key(t_inc, t_status) > _pack_key(inc_j, status_j))
            )
            known_j = known_j | take
            status_j = torch.where(better, t_status, status_j)
            inc_j = torch.where(better, t_inc, inc_j)
        joined = joiner & jvalid.any(dim=1)
        jr = joined[:, None]
        keep_self = is_self & jr
        merged_known = torch.where(jr, known_j, state.known)
        merged_status = torch.where(keep_self, ALIVE, torch.where(jr, status_j, state.status))
        merged_inc = torch.where(keep_self, state.inc, torch.where(jr, inc_j, state.inc))
        learned = jr & merged_known & ~is_self
        state = state._replace(
            known=merged_known,
            status=merged_status,
            inc=merged_inc,
            ready=state.ready | joined,
            ch_active=state.ch_active | learned,
            ch_status=torch.where(learned, merged_status, state.ch_status),
            ch_inc=torch.where(learned, merged_inc, state.ch_inc),
            ch_source=torch.where(learned, node, state.ch_source),
            ch_source_inc=torch.where(
                learned, _diag(merged_inc, lo)[:, None], state.ch_source_inc
            ),
            ch_pb=torch.where(learned, 0, state.ch_pb),
        )
        # contacted nodes makeAlive(joiner): a write into the contacted
        # nodes' rows at the joiners' columns, reduce-scattered to the rows'
        # shards
        ja_mask = _zeros((n, n), b8, dev)
        cols = torch.arange(lo, lo + rows, dtype=torch.int64, device=dev)
        for k in range(params.join_size):
            upd = _zeros((n, n), b8, dev).index_put(
                (jorder[:, k], cols), jvalid[:, k] & joined
            )
            ja_mask = ja_mask | upd
        ja_mask = yield ("rs_any", ja_mask)
        self_inc = (yield ("gather", _diag(state.inc, lo)))[None, :].expand(rows, n)
        state, ja_applied, _, _, _ = _classic_apply(
            lo,
            state,
            now,
            ja_mask,
            torch.full((rows, n), ALIVE, dtype=i32, device=dev),
            self_inc,
            subject.expand(rows, n),
            self_inc,
        )
        return (
            state,
            joined,
            ja_applied if dense else None,
            ja_applied.any(dim=1),
            # the fused tick's applied-cells union is seeded here; the
            # classic tick sums its dense masks instead
            union0 | toolkit.pack_bool_rows(ja_applied) if ft_on else union0,
        )

    state, joined, ja_applied, ja_rows, union = yield from _phase(
        gate,
        joiner.any(),
        _join_phase,
        lambda s: (
            s,
            zeros_n,
            _zeros((rows, n), b8, dev) if dense else None,
            zeros_n,
            union0,
        ),
        state,
    )

    # rows whose VIEW changed so far this tick
    dirty = rv | rejoin | joined | ja_rows
    if inputs.leave is not None:
        dirty = dirty | lv
    # fused parity mode also tracks WHICH cells changed (over-approximating
    # whole revived/joined rows is bit-neutral)
    changed_mid = None
    if fused:
        changed_mid = (
            rv[:, None]
            | (joined[:, None] & state.known)
            | (rejoin[:, None] & is_self)
            | ja_applied
        )
        if inputs.leave is not None:
            changed_mid = changed_mid | (lv[:, None] & is_self)

    # change-table occupancy before the dissemination phases: the
    # histograms' retirement baseline (those phases only clear ch_active at
    # the piggyback bound, the applies only set it)
    pre_pb_active = state.ch_active

    # what each sender advertises in its ping body: last tick's checksum
    # and its self-incarnation at message-build time
    advertised_checksum = state.checksum
    sent_self_inc = _diag(state.inc, lo)

    # ---- phase 2: target selection (round-robin iterator) -------------
    phase.next("target")
    participating = state.proc_alive & state.ready & state.gossip_on
    pingable = (
        state.known & ((state.status == ALIVE) | (state.status == SUSPECT)) & ~is_self
    )
    _wr = state.perm_inv - state.iter_pos[:, None]
    walk_rank = _wr + (_wr < 0).to(i32) * n
    masked_rank = torch.where(pingable, walk_rank, n)
    first_k = masked_rank.min(dim=1).values.to(i32)
    has_target = first_k < n
    target = masked_rank.argmin(dim=1).to(i32)  # the first minimum
    target = torch.where(participating & has_target, target, NO_TARGET)
    wrapped = has_target & ((state.iter_pos + first_k) >= n)
    iter_pos = torch.where(
        participating & has_target, (state.iter_pos + first_k + 1) % n, state.iter_pos
    )
    # reshuffle on wrap: rows re-drawn as affine re-indexings of one shared
    # hashed base permutation (see the JAX engine for the derivation); the
    # base is drawn from every node's key, so its draws are all-gathered
    resh = wrapped & participating
    coprimes = _coprimes_of(n)[0]

    def _reshuffled(_):
        draws = yield ("gather", _uniform(state.rng, (rows,), salt=77))
        base = torch.argsort(draws, stable=True)
        base_inv = _zeros(n, i32, dev).index_put((base,), ids)
        r = _uniform(state.rng, (rows, 2), salt=7)
        k_cop = len(coprimes)
        a_idx = (r[:, 0] * k_cop).to(i32).clamp(0, k_cop - 1)
        a_inv = _coprime_invs_on(n, dev)[a_idx.long()]
        b = (r[:, 1] * float(n)).to(i32) % n
        d = base_inv[None, :] - b[:, None]
        d = d + (d < 0).to(i32) * n
        x = a_inv[:, None] * d
        if n <= 4096:  # n*n < 2^24: the float32-exact quotient path
            q = torch.floor(x.to(torch.float32) / float(n)).to(i32)
            idx = x - q * n
            idx = idx + (idx < 0).to(i32) * n
            idx = idx - (idx >= n).to(i32) * n
        else:
            idx = x % n
        return torch.where(resh[:, None], idx, state.perm_inv)

    perm_inv = yield from _phase(gate, resh.any(), _reshuffled, lambda _: state.perm_inv, None)
    state = state._replace(perm_inv=perm_inv, iter_pos=iter_pos)
    valid_send = target >= 0

    # ---- phase 3: sender piggyback selection (issueAsSender) ----------
    phase.next("piggyback")
    server_count = (
        state.known & ((state.status == ALIVE) | (state.status == SUSPECT))
    ).sum(dim=1, dtype=i32)
    max_pb = _max_piggyback(server_count, params.piggyback_factor)

    def _sender_piggyback(state):
        if ft_on:
            out = _budget(ft, state.ch_active, state.ch_pb, valid_send.to(i32), max_pb)
            return state._replace(ch_pb=out.ch_pb, ch_active=out.ch_active), out.content, out.drops
        bump = valid_send[:, None] & state.ch_active
        ch_pb = state.ch_pb + bump.to(i32)
        over = state.ch_active & (ch_pb > max_pb[:, None])
        state = state._replace(ch_pb=ch_pb, ch_active=state.ch_active & ~over)
        return state, bump & ~over, over.sum(dtype=i32)

    state, sendable, pb_drops_send = yield from _phase(
        gate,
        state.ch_active.any(),
        _sender_piggyback,
        lambda s: (s, _zeros((rows, n), b8, dev), zero_i),
        state,
    )

    # ---- phase 4: delivery mask ---------------------------------------
    phase.next("delivery")
    tclip = target.clamp(0, n - 1).to(torch.int64)
    loss = _uniform(state.rng, (rows,), salt=13) < params.packet_loss
    tgt_ok = valid_send & alive_all[tclip]
    conn = valid_send & (partition == partition_all[tclip])
    delivered = valid_send & tgt_ok & conn & ~loss

    # ---- phase 5: receivers apply ping changes ------------------------
    phase.next("receive")
    seg = torch.where(delivered, target, n)
    msg_content = sendable & delivered[:, None]
    deadline = tick_next + params.suspicion_ticks

    def _receive_phase(state, union):
        # each sender's row folds onto its target's row: a segment
        # reduction over the senders, reduce-scattered to the receivers
        keys = torch.where(msg_content, _pack_key(state.ch_inc, state.ch_status), -1)
        recv_key = yield ("rs_max", toolkit.segment_reduce(keys, seg, n, "amax", INT32_MIN))
        recv_mask = recv_key >= 0
        # winning sender (lowest index among ties) recovers source fields
        (recv_at_target,) = yield from _fetch(tclip, recv_key)
        is_winner = (keys == recv_at_target) & msg_content
        sender_ids = node.expand(rows, n)
        winner_sender = yield ("rs_min", toolkit.segment_reduce(
            torch.where(is_winner, sender_ids, n), seg, n, "amin", INT32_MAX
        ))
        (winner_at_target,) = yield from _fetch(tclip, winner_sender)
        final_w = is_winner & (sender_ids == winner_at_target)
        u_source = yield ("rs_max", toolkit.segment_reduce(
            torch.where(final_w, state.ch_source, INT32_MIN), seg, n, "amax", INT32_MIN
        ))
        u_source_inc = yield ("rs_max", toolkit.segment_reduce(
            torch.where(final_w, state.ch_source_inc, INT32_MIN), seg, n, "amax", INT32_MIN
        ))
        state, union, applied, applied_rows, refute_diag, _ = _apply_site(
            ft, state, union, recv_mask, recv_key % 4, torch.div(recv_key, 4, rounding_mode="floor"),
            u_source, u_source_inc, now, deadline, want_masks=want_masks, lo=lo,
        )
        return state, union, applied, applied_rows, refute_diag

    state, union, applied_ping, rows_ping, refute_recv = yield from _phase(
        gate,
        msg_content.any(),
        _receive_phase,
        lambda s, u: (s, u, _zeros((rows, n), b8, dev) if dense else None, zeros_n, zeros_n),
        state,
        union,
    )
    dirty = dirty | rows_ping
    if fused:
        changed_mid = changed_mid | applied_ping

    # receiver-side piggyback bump: one issueAsReceiver per delivered ping,
    # origin-filtered before the bump (dissemination.js:147-160)
    nrecv = yield ("rs_sum", _segment_sum(delivered.to(i32), seg, n))

    def _receiver_bump(state):
        delivered_all = yield ("gather", delivered)
        target_all = yield ("gather", target)
        sent_inc_all = yield ("gather", sent_self_inc)
        src_c = state.ch_source.clamp(0, n - 1).to(torch.int64)
        origin_hit = (
            state.ch_active
            & (state.ch_source >= 0)
            & delivered_all[src_c]
            & (target_all[src_c] == node)
            & (state.ch_source_inc == sent_inc_all[src_c])
        )
        if ft_on:
            out = _budget(ft, state.ch_active, state.ch_pb, nrecv, max_pb, origin_hit.to(i32))
            return state._replace(ch_pb=out.ch_pb, ch_active=out.ch_active), out.content, out.drops
        bump_r = (nrecv[:, None] > 0) & state.ch_active
        nbump = torch.where(bump_r, nrecv[:, None] - origin_hit.to(i32), 0)
        ch_pb = state.ch_pb + nbump
        over_r = state.ch_active & (ch_pb > max_pb[:, None])
        state = state._replace(ch_pb=ch_pb, ch_active=state.ch_active & ~over_r)
        return state, bump_r & ~over_r, over_r.sum(dtype=i32)

    state, respondable, pb_drops_recv = yield from _phase(
        gate,
        state.ch_active.any(),
        _receiver_bump,
        lambda s: (s, _zeros((rows, n), b8, dev), zero_i),
        state,
    )

    # mid-tick checksums (receivers respond with post-update checksums)
    phase.next("checksum.mid")
    mid_checksum, mid_overflow, state = yield from _checksums_where(
        sh, state, universe, params, dirty, state.checksum, changed_mid
    )
    mid_all = yield ("gather", mid_checksum)

    # ---- phase 6: responses (issueAsReceiver + full-sync) -------------
    phase.next("respond")
    cur_self_inc = _diag(state.inc, lo)
    respondable_any = yield ("gather", respondable.any(dim=1))
    resp_possible = delivered & (
        respondable_any[tclip] | (mid_all[tclip] != advertised_checksum)
    )

    def _response_phase(state, union):
        # the target's row of every plane the response reads
        (t_source, t_source_inc, t_respondable, t_known, t_status, t_inc, t_ch_status,
         t_ch_inc) = yield from _fetch(
            tclip, state.ch_source, state.ch_source_inc, respondable, state.known,
            state.status, state.inc, state.ch_status, state.ch_inc)
        self_inc_all = yield ("gather", _diag(state.inc, lo))
        resp_filter = (t_source == node) & (t_source_inc == sent_self_inc[:, None])
        resp_mask = delivered[:, None] & t_respondable & ~resp_filter
        any_resp_change = resp_mask.any(dim=1)
        full_sync = delivered & ~any_resp_change & (mid_all[tclip] != advertised_checksum)
        fs_mask = full_sync[:, None] & t_known
        r_status = torch.where(fs_mask, t_status, t_ch_status)
        r_inc = torch.where(fs_mask, t_inc, t_ch_inc)
        r_source = torch.where(fs_mask, target[:, None], t_source)
        r_source_inc = torch.where(fs_mask, self_inc_all[tclip][:, None], t_source_inc)
        state, union, applied, applied_rows, refute_diag, _ = _apply_site(
            ft, state, union, resp_mask | fs_mask, r_status, r_inc, r_source,
            r_source_inc, now, deadline, want_masks=want_masks, lo=lo,
        )
        fs_rec = fs_mask.sum(dim=1, dtype=i32)
        return state, union, applied, applied_rows, full_sync, refute_diag, fs_rec

    state, union, applied_resp, rows_resp, full_sync, refute_resp, fs_rec_rows = yield from _phase(
        gate,
        resp_possible.any(),
        _response_phase,
        lambda s, u: (
            s, u, _zeros((rows, n), b8, dev) if dense else None,
            zeros_n, zeros_n, zeros_n, _zeros(rows, i32, dev),
        ),
        state,
        union,
    )
    fs_records = fs_rec_rows.sum(dtype=i32)

    # ---- phase 7: ping-req (indirect probe) ---------------------------
    phase.next("ping_req")
    need_pr = valid_send & ~delivered
    K = params.ping_req_size

    on_card = _ping_req_kernels(ft, sh, n)

    def _ping_req_phase(state, union):
        if on_card:
            with perf.span("ping_req.select"):
                pr_sel, pr_valid = prk.ping_req_select(pingable, target, need_pr, state.rng, K)
        else:
            pr_sel, pr_valid = prk.ping_req_select_plain(pingable, target, need_pr, state.rng, K)

        m_alive = alive_all[pr_sel]
        m_conn = partition_all[pr_sel] == partition[:, None]
        loss1 = _uniform(state.rng, (rows, K), salt=31) < params.packet_loss
        responder = pr_valid & m_alive & m_conn & ~loss1
        t_alive = need_pr & alive_all[tclip]
        t_conn = partition_all[pr_sel] == partition_all[tclip][:, None]
        loss2 = _uniform(state.rng, (rows, K), salt=37) < params.packet_loss
        reached = responder & t_alive[:, None] & t_conn & ~loss2

        any_responded = responder.any(dim=1)
        target_reached = reached.any(dim=1)
        mark_suspect = need_pr & any_responded & ~target_reached
        pr_inconclusive = (need_pr & ~any_responded).sum(dtype=i32)
        ping_req_count = (need_pr[:, None] & pr_valid).sum(dtype=i32)
        pr_self_inc = _diag(state.inc, lo)

        # -- leg 1: sender piggyback (issueAsSender per selected slot) --
        pb0, active0 = state.ch_pb, state.ch_active
        n_slots = pr_valid.sum(dim=1, dtype=i32)
        if ft_on:
            # content unused here: slot-k content comes from the pre-bump planes
            out1 = _budget(ft, active0, pb0, n_slots, max_pb, want_content=False)
            state = state._replace(ch_pb=out1.ch_pb, ch_active=out1.ch_active)
            pb_drops_pr = out1.drops
        else:
            new_pb = pb0 + torch.where(active0, n_slots[:, None], 0)
            over_pr = active0 & (new_pb > max_pb[:, None])
            state = state._replace(ch_pb=new_pb, ch_active=active0 & ~over_pr)
            pb_drops_pr = over_pr.sum(dtype=i32)

        # -- leg 2: intermediaries apply (winner-combine per subject) --
        if on_card:
            with perf.span("ping_req.combine"):
                *update_prm, prrecv = prk.ping_req_combine(
                    pr_sel, responder, active0, pb0, max_pb, state.ch_inc, state.ch_status,
                    state.ch_source, state.ch_source_inc)
        else:
            update_prm = yield from prk.combine_legs(
                pr_sel, responder, active0, pb0, max_pb, state.ch_inc, state.ch_status,
                state.ch_source, state.ch_source_inc, lo=lo)
        state, union, applied_prm, rows_prm, refute_m, _ = _apply_site(
            ft, state, union, *update_prm, now, deadline, want_masks=want_masks, lo=lo,
        )

        # -- leg 3: responses (issueAsReceiver per arriving ping-req) --
        if on_card:
            with perf.span("ping_req.respond"):
                hits = prk.ping_req_hits(pr_sel, responder, state.ch_active, state.ch_source,
                                         state.ch_source_inc, pr_self_inc)
        else:
            hits, prrecv = yield from prk.hits_legs(pr_sel, responder, state.ch_active,
                                                    state.ch_source, state.ch_source_inc,
                                                    pr_self_inc, lo=lo)
        if ft_on:
            out3 = _budget(ft, state.ch_active, state.ch_pb, prrecv, max_pb, hits)
            respondable_pr = out3.content
            state = state._replace(ch_pb=out3.ch_pb, ch_active=out3.ch_active)
            pb_drops_pr = pb_drops_pr + out3.drops
        else:
            bump_pr = (prrecv[:, None] > 0) & state.ch_active
            nb = torch.where(bump_pr, prrecv[:, None] - hits, 0)
            ch_pb2 = state.ch_pb + nb
            over2 = state.ch_active & (ch_pb2 > max_pb[:, None])
            respondable_pr = bump_pr & ~over2
            state = state._replace(ch_pb=ch_pb2, ch_active=state.ch_active & ~over2)
            pb_drops_pr = pb_drops_pr + over2.sum(dtype=i32)

        # response content per slot, winner-combined at the sender (max
        # key; ties keep the lowest slot); per-slot full syncs and their
        # record counts, [R, K]: the metrics are their sums, the flight
        # recorder emits them per event
        if on_card:
            with perf.span("ping_req.respond"):
                *update_prr, pr_fs, pr_fs_rec = prk.ping_req_respond(
                    pr_sel, responder, respondable_pr, state.ch_source, state.ch_source_inc,
                    state.known, state.status, state.inc, state.ch_status, state.ch_inc,
                    pr_self_inc, mid_checksum)
        else:
            *update_prr, pr_fs, pr_fs_rec = yield from prk.respond_legs(
                pr_sel, responder, respondable_pr, state.ch_source, state.ch_source_inc,
                state.known, state.status, state.inc, state.ch_status, state.ch_inc,
                pr_self_inc, mid_checksum, mid_all, lo=lo)
        state, union, applied_prr, rows_prr, refute_rr, _ = _apply_site(
            ft, state, union, *update_prr, now, deadline, want_masks=want_masks, lo=lo,
        )

        # -- suspect verdict, on post-response state (the sender's own row) --
        local_rows = torch.arange(rows, dtype=torch.int64, device=dev)
        sus_mask = _zeros((rows, n), b8, dev).index_put((local_rows, tclip), mark_suspect)
        sus_inc = state.inc[local_rows, tclip]  # the member's current inc
        cur_self = _diag(state.inc, lo)
        state, union, applied_sus, rows_sus, _, sus_cnt = _apply_site(
            ft, state, union, sus_mask,
            torch.full((rows, n), SUSPECT, dtype=i32, device=dev),
            sus_inc[:, None].expand(rows, n),
            node.expand(rows, n),
            cur_self[:, None].expand(rows, n),
            now, deadline, want_masks=want_masks, want_count=True, want_refute=False, lo=lo,
        )
        applied_pr = (applied_prm | applied_prr | applied_sus) if dense else None
        return (
            state, union, applied_sus, applied_pr, rows_prm | rows_prr | rows_sus, sus_cnt,
            ping_req_count, pr_inconclusive, pb_drops_pr, refute_m, refute_rr, pr_fs, pr_fs_rec,
            pr_sel,
        )

    (
        state, union, applied_sus, applied_pr, rows_pr, sus_count, ping_req_count,
        pr_inconclusive, pb_drops_pr, refute_prm, refute_prr, pr_fs_mask, pr_fs_recs, pr_sel,
    ) = yield from _phase(
        gate,
        need_pr.any(),
        _ping_req_phase,
        lambda s, u: (
            s, u, _zeros((rows, n), b8, dev) if dense else None,
            _zeros((rows, n), b8, dev) if dense else None, zeros_n,
            zero_i, zero_i, zero_i, zero_i, zeros_n, zeros_n,
            _zeros((rows, K), b8, dev), _zeros((rows, K), i32, dev),
            _zeros((rows, K), torch.int64, dev),
        ),
        state,
        union,
    )
    pr_fs_count = pr_fs_mask.sum(dtype=i32)
    pr_fs_records = pr_fs_recs.sum(dtype=i32)

    # ---- phase 8: suspicion expiry ------------------------------------
    phase.next("expiry")
    def _expired(state):
        return (
            (state.susp_deadline >= 0)
            & (state.susp_deadline <= tick_next)
            & participating[:, None]
        )

    def _expiry_phase(state):
        expired = _expired(state)
        state = state._replace(susp_deadline=torch.where(expired, -1, state.susp_deadline))
        # faulty marks are excluded from the changes_applied union
        state, _u, applied, applied_rows, _rd, cnt = _apply_site(
            ft, state, None, expired,
            torch.full((rows, n), FAULTY, dtype=i32, device=dev),
            state.inc,  # member's current incarnation (suspicion.js:67-70)
            node.expand(rows, n),
            cur_self_inc[:, None].expand(rows, n),
            now, deadline, want_masks=want_masks, want_count=True, want_refute=False, lo=lo,
        )
        return state, applied, applied_rows, cnt

    state, applied_faulty, rows_faulty, faulty_count = yield from _phase(
        gate,
        _expired(state).any(),
        _expiry_phase,
        lambda s: (s, _zeros((rows, n), b8, dev) if dense else None, zeros_n, zero_i),
        state,
    )

    # ---- phase 9: checksums + metrics ---------------------------------
    phase.next("checksum")
    dirty_late = rows_resp | rows_pr | rows_faulty
    changed_late = (applied_resp | applied_pr | applied_faulty) if fused else None
    checksum, late_overflow, state = yield from _checksums_where(
        sh, state, universe, params, dirty_late, mid_checksum, changed_late
    )
    state = state._replace(checksum=checksum)

    # distinct checksums among participants: sort, count boundaries
    part = state.proc_alive & state.ready
    sentinel = 0xFFFFFFFF
    cs_all = yield ("gather", torch.where(part, u32.to_u64(checksum), sentinel))
    cs_sorted = torch.sort(cs_all).values
    distinct = (
        ((cs_sorted[1:] != cs_sorted[:-1]) & (cs_sorted[1:] != sentinel)).sum(dtype=i32)
        + (cs_sorted[0] != sentinel).to(i32)
    )

    if ft_on:
        # the fused sites fed the applied-cells union in-pass
        changes_applied = toolkit.popcount(union).sum(dtype=i32)
    else:
        # faulty marks are excluded, exactly like the fused union
        changes_applied = (applied_ping | applied_resp | applied_pr | ja_applied).sum(dtype=i32)
    # the shard's shares of the whole-cluster counts, summed across shards
    # (every other metric is whole-cluster already)
    shares = dict(
        pings_sent=valid_send.sum(dtype=i32),
        pings_delivered=delivered.sum(dtype=i32),
        ping_reqs=ping_req_count,
        full_syncs=full_sync.sum(dtype=i32) + pr_fs_count,
        changes_applied=changes_applied,
        suspects_marked=sus_count,
        faulties_marked=faulty_count,
        refutes=refute_recv.sum(dtype=i32)
        + refute_resp.sum(dtype=i32)
        + refute_prm.sum(dtype=i32)
        + refute_prr.sum(dtype=i32),
        piggyback_drops=pb_drops_send + pb_drops_recv + pb_drops_pr,
        full_sync_records=fs_records + pr_fs_records,
        ping_req_inconclusive=pr_inconclusive,
        join_merges=joined.sum(dtype=i32),
        dirty_rows=dirty.sum(dtype=i32) + dirty_late.sum(dtype=i32),
    )
    totals = dict(zip(shares, (yield ("sum", tuple(shares.values())))))
    metrics = TickMetrics(
        distinct_checksums=distinct,
        converged=distinct <= 1,
        parity_overflow=mid_overflow + late_overflow,
        **totals,
    )
    phase.end()

    # ---- flight recorder and latency histograms (obs planes) ----------
    # written after every protocol phase from the masks that drove them;
    # nothing below writes protocol state
    if params.flight_recorder:
        state = yield from flight.record_tick_events(
            sh, state, tick_next, prev_known, prev_status,
            flight.TickEventMasks(
                valid_send=valid_send, target=target, delivered=delivered,
                applied_ping=applied_ping, applied_resp=applied_resp, applied_pr=applied_pr,
                ja_applied=ja_applied, applied_sus=applied_sus,
                applied_faulty=applied_faulty, joined=joined, full_sync=full_sync,
                fs_rec_rows=fs_rec_rows, pr_fs_mask=pr_fs_mask, pr_fs_recs=pr_fs_recs,
                pr_sel=pr_sel, refute_recv=refute_recv, refute_resp=refute_resp,
                refute_prm=refute_prm, refute_prr=refute_prr, revived=rv, left=lv,
                rejoined=rejoin,
            ),
            n, params.event_capacity,
        )
    if params.histograms:
        # the bumps over the shard's own rows, summed across the shards
        # (every shard holds the whole counters)
        part = torch.zeros_like(state.hist)
        # rumor age at first-heard: gossip adoptions landing ALIVE
        adopted = (
            (applied_ping | applied_resp | applied_pr)
            & ~is_self & (state.status == ALIVE) & (state.inc > 0)
        )
        part = hg.record(part, HIST_TRACKS.index("rumor_age"), tick_next + 1 - state.inc, adopted)
        # rumor age at retirement: the piggyback drop (dissemination.js:41)
        part = hg.record(part, HIST_TRACKS.index("retired_age"), tick_next + 1 - state.ch_inc,
                         pre_pb_active & ~state.ch_active)
        # suspicion duration at timer stop; revive resets forget timers
        stopped = (prev_susp >= 0) & (state.susp_deadline == -1) & ~rv[:, None]
        part = hg.record(part, HIST_TRACKS.index("suspicion_duration"),
                         tick_next - prev_susp + params.suspicion_ticks, stopped)
        hist = state.hist + (yield ("sum", part))
        # the whole cluster's dirty rows: one observation, recorded once
        hist = hg.record_count(hist, HIST_TRACKS.index("dirty_rows"), metrics.dirty_rows)
        state = state._replace(hist=hist)

    state = state._replace(rng=_fold(state.rng, 0x5EED))
    return state, metrics
