"""Scalable SWIM engine: O(N·U) state for 100k-1M simulated nodes.

Counterpart of ``ringpop_tpu/models/sim/engine_scalable.py``, held against
it bit for bit (tests/test_torch_scalable.py).  The module docstring there
gives the model: global truth arrays ``[N]``, a bounded table of batch
rumors (one per tick and event class, each carrying only the checksum
delta of its subject set) and per-node heard bitmasks ``[N, U/32]``; a
node's checksum is ``base_sum`` plus the deltas of the active rumors it
heard, maintained incrementally inside the tick.

What differs from the JAX engine is the execution, not the arithmetic:

- uint32 values are int32 bit patterns (:mod:`ringpop_tpu_torch.ops.u32`):
  every right shift of one is logical (``u32.srl``), unsigned order goes
  through the sign flip;
- JAX's ``mode="drop"`` scatters become scatters into ``n + 1`` slots
  whose last slot is sliced off;
- the rumor-delta sums are exact int64 sums (``ops.exchange.
  delta_sum_plain``), not a float32 limb matmul, so the TF32 matmul switch
  cannot touch them;
- PyTorch runs eagerly: the PRP cycle walk and every gated phase read a
  device predicate on the host (:func:`host_read` counts them).

``fused_exchange`` takes "kernel" (the CUDA kernel ``csrc/exchange.cu``),
"plain" (its plain PyTorch version) or "off" (the inline classic phases);
"auto" is "kernel" on the card and "plain" on the CPU.  All three give the
same trajectory.  The mesh's ``exchange_plane`` seam is not ported yet
(ROADMAP.md queue A, A11).

The obs planes, off by default, write-only and trajectory-neutral (no host
read either): ``wavefront`` keeps ``first_heard[i, r]``, the tick node i's
heard bit for rumor slot r turned on; ``histograms`` bumps the log2
counters of :data:`SCALABLE_HIST_TRACKS`; ``exchange_metrics = S`` keeps
the per-shard exchange counters of an S-shard plane, modelled
analytically from the tick's permutation (:func:`_exchange_obs_update`).
The rumor-age track counts each rumor column's new heard bits (a bitwise
column sum of the new-bit words) into the bucket of the column's age —
the same counters as one observation per new bit, without the [N, U]
expansion, which only the wavefront stamp builds (in row chunks).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.ops import exchange as _exchange
from ringpop_tpu_torch.ops import histogram as hg
from ringpop_tpu_torch.ops import toolkit, u32
from ringpop_tpu_torch.ops.record_mix import record_mix

ALIVE, SUSPECT, FAULTY, LEAVE = 0, 1, 2, 3

WORD = 32
SLOTS_PER_TICK = 3  # suspect, faulty, alive (revive/refute/rejoin)

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1
_U32_ALL = -1  # 0xFFFFFFFF as an int32 bit pattern

# ScalableState.hist rows, in order (observations in ticks): per newly-set
# heard bit, tick - r_birth of its rumor; per retired rumor slot, tick -
# r_birth at the aging drop or recycle; per stopped suspicion clock, tick -
# susp_since at refute-cancel or faulty expiry
SCALABLE_HIST_TRACKS = ("rumor_age", "retired_age", "suspicion_duration")

# elements of one row chunk of the wavefront stamp's [rows, U] temporaries
_WAVE_CHUNK = 1 << 26


def slots_per_tick(params: "ScalableParams") -> int:
    """3 rumor classes per tick, +1 (leave) when the feature is enabled."""
    return SLOTS_PER_TICK + (1 if params.enable_leave else 0)


class ScalableParams(NamedTuple):
    n: int
    u: int = 512  # rumor table capacity; must cover SLOTS_PER_TICK * max_age
    ping_req_size: int = 3  # index.js:113
    suspicion_ticks: int = 25  # 5000 ms / 200 ms — suspicion.js:111-113
    piggyback_factor: int = 15  # dissemination.js:41
    age_slack: int = 8  # extra ticks beyond max piggyback before drop
    packet_loss: float = 0.0
    epoch: int = 1414142122274
    # checksums every tick cost O(N*U) bandwidth; compute_checksums gives
    # them on demand instead
    checksum_in_tick: bool = True
    # graceful leaves allocate a 4th rumor slot per tick
    enable_leave: bool = False
    # True: rare phases run only when their predicate holds (one host read
    # each); False: straight-line.  Bitwise-identical trajectories.
    gate_phases: bool = True
    # "sortless": analytic PRP inverse; "argsort": the same forward values,
    # inverse by argsort (bit-identical); "auto" -> "sortless"
    perm_impl: str = "auto"
    # "kernel" | "plain" | "off" | "auto" (module docstring)
    fused_exchange: str = "auto"
    # the obs planes (module docstring); exchange_metrics = S models an
    # S-shard exchange plane (S must divide n), 0 = off
    wavefront: bool = False
    histograms: bool = False
    exchange_metrics: int = 0


class ScalableState(NamedTuple):
    tick_index: torch.Tensor  # [] int32
    proc_alive: torch.Tensor  # [N] bool — process up (fault plane)
    gossip_on: torch.Tensor  # [N] bool — False after a graceful leave
    partition: torch.Tensor  # [N] int32 — group id
    truth_status: torch.Tensor  # [N] int32 — latest asserted status
    truth_inc: torch.Tensor  # [N] int32 tick stamp (0 = never)
    r_active: torch.Tensor  # [U] bool
    r_delta: torch.Tensor  # [U] int32 (uint32) — checksum delta
    r_birth: torch.Tensor  # [U] int32 — tick published
    heard: torch.Tensor  # [N, U/32] int32 (uint32) reception bitmask
    susp_subject: torch.Tensor  # [N] int32 — -1 or the suspected node
    susp_since: torch.Tensor  # [N] int32
    defame_slot: torch.Tensor  # [N] int32 — -1 none, -2 recycled
    defame_by: torch.Tensor  # [N] int32 — representative accuser
    base_sum: torch.Tensor  # [] int32 (uint32)
    rng: torch.Tensor  # [2] int32 (uint32)
    checksum: torch.Tensor  # [N] int32 (uint32)
    # obs planes (None when off): [N, U] int32 first-heard tick (-1 never);
    # [len(SCALABLE_HIST_TRACKS), NBUCKETS], [S, len(EXCH_COUNTERS)] and
    # [S, len(EXCH_HIST_TRACKS), NBUCKETS] int32 (uint32 counters)
    first_heard: Optional[torch.Tensor] = None
    hist: Optional[torch.Tensor] = None
    exch: Optional[torch.Tensor] = None
    exch_hist: Optional[torch.Tensor] = None


# ScalableState fields indexed by NODE along axis 0 — the sharded
# checkpoint split (models/sim/recovery.py) and, on a mesh, the node
# sharding.  Decided by NAME, not shape: u == n would make shape checks
# ambiguous.  Everything else — the bounded [U] rumor table, the scalar
# clock/base, the rng, the telemetry wavefront — stays in the common
# checkpoint file.  The exchange-telemetry planes (``exch``,
# ``exch_hist``) are indexed by SHARD, not node, and are not in this set,
# so checkpoints keep the tiny planes in the common file at any shard
# count.
NODE_SHARDED_FIELDS = frozenset(
    {
        "proc_alive",
        "gossip_on",
        "partition",
        "truth_status",
        "truth_inc",
        "heard",
        "susp_subject",
        "susp_since",
        "defame_slot",
        "defame_by",
        "checksum",
    }
)


# trajectory vs obs-only ScalableState fields, as in the JAX engine
# (``SCALABLE_OBS_ONLY_FIELDS`` / ``SCALABLE_TRAJECTORY_FIELDS``; the note
# at engine.SIM_OBS_ONLY_FIELDS)
SCALABLE_OBS_ONLY_FIELDS = frozenset({"first_heard", "hist", "exch", "exch_hist"})
SCALABLE_TRAJECTORY_FIELDS = frozenset({
    "tick_index", "proc_alive", "gossip_on", "partition", "truth_status", "truth_inc",
    "r_active", "r_delta", "r_birth", "heard", "susp_subject", "susp_since", "defame_slot",
    "defame_by", "base_sum", "rng", "checksum",
})


class ScalableMetrics(NamedTuple):
    live_nodes: torch.Tensor
    active_rumors: torch.Tensor
    mean_heard_frac: torch.Tensor  # float32 mean fraction of active rumors heard
    full_coverage: torch.Tensor
    distinct_checksums: torch.Tensor
    suspects_published: torch.Tensor
    faulties_published: torch.Tensor
    refutes_published: torch.Tensor
    leaves_published: torch.Tensor
    pings_sent: torch.Tensor
    pings_delivered: torch.Tensor
    ping_req_inconclusive: torch.Tensor
    rumors_retired: torch.Tensor


class ChurnInputs(NamedTuple):
    kill: torch.Tensor  # [N] bool
    revive: torch.Tensor  # [N] bool — restart a dead process or rejoin a left node
    partition: Optional[torch.Tensor] = None  # [N] int32, -1 keeps current
    leave: Optional[torch.Tensor] = None  # [N] bool graceful leave

    @staticmethod
    def quiet(n: int, device="cpu") -> "ChurnInputs":
        z = torch.zeros(n, dtype=torch.bool, device=device)
        return ChurnInputs(kill=z, revive=z)


def host_read(pred) -> bool:
    """A device predicate read on the host: one device sync on the card.
    ``host_read.count`` counts every read (the storm reports it per tick)."""
    host_read.count += 1
    return bool(pred)


host_read.count = 0


def _phase(gate: bool, pred, true_fn, false_fn, *ops):
    """``true_fn(*ops)`` if ``pred`` else ``false_fn(*ops)`` when gated,
    else ``true_fn(*ops)`` unconditionally (the JAX engine's
    ``gating.phase``; the TRUE branch is a masked no-op on empty inputs)."""
    if gate and not host_read(pred):
        return false_fn(*ops)
    return true_fn(*ops)


# ---------------------------------------------------------------------------
# counter-based randomness


def _rand_u32(key: torch.Tensor, shape, salt: int) -> torch.Tensor:
    """``shape`` uint32 draws from the [2] key (``[..., 2]`` keys give
    ``[..., *shape]``: one row of draws per key)."""
    size = math.prod(shape)
    i = torch.arange(size, dtype=torch.int32, device=key.device)
    x = key[..., 0, None] + i * u32.s32(0x01000193) + u32.s32(salt)
    x = x ^ u32.srl(key[..., 1, None], 7)
    x = x ^ u32.srl(x, 15)
    x = x * u32.s32(0x2C1B3C6D)
    x = x ^ u32.srl(x, 12)
    x = x * u32.s32(0x297A2D39)
    x = x ^ u32.srl(x, 15)
    return x.reshape(tuple(key.shape[:-1]) + tuple(shape))


def _uniform(key, shape, salt) -> torch.Tensor:
    return u32.to_f32(_rand_u32(key, shape, salt)) / float(2**32)


def _fold(key: torch.Tensor, salt: int) -> torch.Tensor:
    k0 = key[0] * u32.s32(0x9E3779B9) + u32.s32(salt)
    k1 = key[1] ^ ((k0 << 13) | u32.srl(k0, 19))
    return torch.stack([k1 * u32.s32(0x85EBCA6B) + 1, k0 ^ k1])


def _seq_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-wise float32 sums of ``[R, C]``, each row added left to right."""
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _xla_mean_f32(x: torch.Tensor) -> torch.Tensor:
    """The float32 mean of a [N] vector, rounded as the JAX engine's
    ``jnp.mean(jnp.where(proc_alive, frac, 1.0))`` is in its jitted tick on
    the XLA CPU backend (ROADMAP.md C1; found by matching that expression
    inside a scanned ``lax.cond`` at N = 5-32, 48, 64, 100, 1000, 4096):

    - N > 32: XLA rewrites the reduction into windows of 32 (the vector
      zero-padded to a multiple of 32, the padding split evenly, the odd
      one after), each window summed left to right, level by level; the
      last level (<= 32 values) is summed left to right too;
    - N <= 32: the reduction stays fused with its producer and LLVM
      vectorizes it from N = 16: 8 lanes when N % 8 < 4, else 4, the
      lanes folded in halves, the remainder added after; below 16, left
      to right;
    - the division by N is a multiply by ``float32(1 / N)``.
    """
    n = x.shape[0]
    scale = float(np.float32(1) / np.float32(n))
    if n <= 32:
        vf = 1 if n < 16 else (8 if n % 8 < 4 else 4)
        m = n // vf * vf
        acc = _seq_sum_rows(x[:m].reshape(-1, vf).t())  # [vf] lane sums
        while acc.shape[0] > 1:
            half = acc.shape[0] // 2
            acc = acc[:half] + acc[half:]
        total = acc[0]
        for j in range(m, n):
            total = total + x[j]
        return total * scale
    while x.shape[0] > 1:
        m = x.shape[0]
        padded = -(-m // 32) * 32
        lo = (padded - m) // 2
        x = _seq_sum_rows(torch.nn.functional.pad(x, (lo, padded - m - lo)).reshape(-1, 32))
    return x[0] * scale


# ---------------------------------------------------------------------------
# sortless partner permutation: keyed 4-round Feistel PRP, cycle-walked

_PRP_ROUNDS = 4


def _prp_f(r: torch.Tensor, k: torch.Tensor, mask: int) -> torch.Tensor:
    """Feistel round function truncated to the half-width."""
    x = r * u32.s32(0x7FEB352D) + k
    x = x ^ u32.srl(x, 15)
    x = x * u32.s32(0x846CA68B)
    x = x ^ u32.srl(x, 13)
    return x & mask


def _prp_half_bits(n: int) -> int:
    """Half-width of the Feistel domain: smallest hb with 4^hb >= n."""
    return max(1, (max(n - 1, 1).bit_length() + 1) // 2)


def _prp_apply(v: torch.Tensor, keys: torch.Tensor, hb: int, inverse: bool = False) -> torch.Tensor:
    """One PRP pass over [0, 4^hb); ``inverse`` runs the rounds backwards.
    ``keys``: [ROUNDS], or [B, ROUNDS] with ``v`` [B, N] (one key set a row)."""
    mask = (1 << hb) - 1
    left = u32.srl(v, hb)
    right = v & mask
    if not inverse:
        for r in range(_PRP_ROUNDS):
            left, right = right, left ^ _prp_f(right, keys[..., r, None], mask)
    else:
        for r in reversed(range(_PRP_ROUNDS)):
            left, right = right ^ _prp_f(left, keys[..., r, None], mask), left
    return (left << hb) | right


def _prp_walk(key: torch.Tensor, n: int, salt: int, inverse: bool) -> torch.Tensor:
    """The keyed bijection over [0, n) for a [2] key ([N]) or for B keys
    ``[B, 2]`` ([B, N]), cycle-walked back into range: each step of the
    walk is one host read, of every row at once."""
    hb = _prp_half_bits(n)
    keys = _rand_u32(key, (_PRP_ROUNDS,), salt)
    x = _prp_apply(torch.arange(n, dtype=torch.int32, device=key.device), keys, hb, inverse)
    while True:
        out = u32.uge(x, n)
        if not host_read(out.any()):
            return x
        x = torch.where(out, _prp_apply(x, keys, hb, inverse), x)


def _prp_perm(key: torch.Tensor, n: int, salt: int, inverse: bool = False) -> torch.Tensor:
    """[N] int32 keyed bijection over [0, n), cycle-walked back into range
    (each step of the walk is one host read); ``inverse=True`` evaluates
    the analytic inverse.  Inside ``torch.func.vmap`` (a batched key) the
    custom op ``ringpop_torch::prp_perm`` walks all B rows together, as the
    JAX engine's vmapped ``while_loop`` does: until every row is in range,
    the rows already done masked, one host read a step."""
    if toolkit.is_batched(key):
        return _prp_perm_op(key, n, salt, inverse)
    return _prp_walk(key, n, salt, inverse)


@torch.library.custom_op(toolkit.LIB + "::prp_perm", mutates_args=())
def _prp_perm_op(key: torch.Tensor, n: int, salt: int, inverse: bool) -> torch.Tensor:
    return _prp_walk(key, n, salt, inverse)


def _prp_perm_rule(info, in_dims, key, n, salt, inverse):
    return _prp_walk(toolkit.batch_front(key, in_dims[0], info.batch_size), n, salt, inverse), 0


torch.library.register_vmap(toolkit.LIB + "::prp_perm", _prp_perm_rule)


def resolve_perm_impl(params: ScalableParams, device_type: str = "cpu") -> str:
    """``perm_impl="auto"`` -> "sortless" on every device."""
    if params.perm_impl != "auto":
        if params.perm_impl not in ("sortless", "argsort"):
            raise ValueError(
                "perm_impl must be auto|sortless|argsort, got %r" % (params.perm_impl,)
            )
        return params.perm_impl
    return "sortless"


def resolve_fused_exchange(params: ScalableParams, device_type: str) -> str:
    """``fused_exchange="auto"`` -> "kernel" on the card, "plain" on the CPU."""
    return toolkit.resolve_impl(
        "fused_exchange",
        params.fused_exchange,
        device_type,
        auto={"cuda": "kernel", "*": "plain"},
        allowed=("kernel", "plain", "off"),
    )


def resolve_scalable_params(params: ScalableParams, device_type: str) -> ScalableParams:
    """Pin the "auto" knobs to concrete values for ``device_type``."""
    return params._replace(
        perm_impl=resolve_perm_impl(params, device_type),
        fused_exchange=resolve_fused_exchange(params, device_type),
    )


def _base_perm_pair(key: torch.Tensor, n: int, impl: str, salt: int):
    """The tick's base permutation and its inverse ("argsort": the inverse
    by argsort of the same bijection — bit-identical)."""
    fwd = _prp_perm(key, n, salt)
    if impl == "argsort":
        inv = torch.argsort(fwd).to(torch.int32)
    else:
        inv = _prp_perm(key, n, salt, inverse=True)
    return fwd, inv


def _pack_mask(bits: torch.Tensor) -> torch.Tensor:
    """[U] bool -> [U/32] int32 (uint32), bit r of word r//32 = bits[r]."""
    return toolkit.pack_bool_rows(bits[None, :])[0]


def max_rumor_age(params: ScalableParams) -> int:
    """Worst-case rumor lifetime in ticks (at full live count)."""
    return params.piggyback_factor * len(str(params.n)) + params.age_slack


def init_state(params: ScalableParams, seed: int = 0, device=None) -> ScalableState:
    dev = resolve_device(device)
    n, u = params.n, params.u
    if u % WORD:
        raise ValueError("rumor capacity u=%d must be a multiple of 32" % u)
    need = slots_per_tick(params) * (max_rumor_age(params) + 2)
    if u < need:
        raise ValueError(
            "rumor table u=%d can recycle a slot before its rumor ages out "
            "(need u >= %d for n=%d): an undisseminated delta would fold "
            "into base_sum and erase real divergence" % (u, need, n)
        )
    rng = np.random.default_rng(seed)
    i32 = dict(dtype=torch.int32, device=dev)
    inc0 = torch.ones(n, **i32)  # stamp 1 == params.epoch
    base = record_mix(torch.arange(n, **i32), torch.zeros(n, **i32), inc0)
    base_sum = u32.row_sum(base, dim=0)
    exch = exch_hist = None
    if params.exchange_metrics:
        s = int(params.exchange_metrics)
        if s < 1 or n % s:
            raise ValueError(
                "exchange_metrics=%d must be a positive divisor of n=%d "
                "(it models an S-shard exchange plane)" % (s, n)
            )
        exch = _exchange.init_exchange_counters(s, dev)
        exch_hist = _exchange.init_exchange_hist(s, dev)
    return ScalableState(
        first_heard=torch.full((n, u), -1, **i32) if params.wavefront else None,
        hist=hg.init(len(SCALABLE_HIST_TRACKS), dev) if params.histograms else None,
        exch=exch,
        exch_hist=exch_hist,
        tick_index=torch.zeros((), **i32),
        proc_alive=torch.ones(n, dtype=torch.bool, device=dev),
        gossip_on=torch.ones(n, dtype=torch.bool, device=dev),
        partition=torch.zeros(n, **i32),
        truth_status=torch.zeros(n, **i32),
        truth_inc=inc0,
        r_active=torch.zeros(u, dtype=torch.bool, device=dev),
        r_delta=torch.zeros(u, **i32),
        r_birth=torch.zeros(u, **i32),
        heard=torch.zeros((n, u // WORD), **i32),
        susp_subject=torch.full((n,), -1, **i32),
        susp_since=torch.full((n,), -1, **i32),
        defame_slot=torch.full((n,), -1, **i32),
        defame_by=torch.full((n,), -1, **i32),
        base_sum=base_sum,
        rng=u32.from_numpy(rng.integers(1, 2**32 - 1, size=2, dtype=np.uint32), dev),
        # the no-rumors value: the tick maintains it incrementally
        checksum=base_sum.expand(n).clone(),
    )


# ---------------------------------------------------------------------------
# batch rumors


def _publish_batch(state, csum, slot, subj_mask, new_status, new_inc, hearer_mask, tick):
    """One batch rumor: scalar delta vs current truth, truth advance, and
    the publishers' heard bits (and first-heard ticks, with the wavefront
    on); the hearers' checksums gain the delta."""
    n = state.proc_alive.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=csum.device)
    prev_h = record_mix(ids, state.truth_status, state.truth_inc)
    new_h = record_mix(ids, new_status, new_inc)
    delta = u32.row_sum(torch.where(subj_mask, new_h - prev_h, 0), dim=0)
    any_ev = subj_mask.any()
    hears = hearer_mask & any_ev
    at = slot.reshape(1).long()
    # the slot's bit as a one-word row mask: OR-ing it into the hearers'
    # rows sets bit slot%32 of word slot//32
    slot_words = _pack_mask(torch.zeros_like(state.r_active).index_fill(0, at, True))
    fh = state.first_heard
    if fh is not None:
        # wavefront: the publishers are the rumor's first hearers.  The
        # matrix is this tick's own copy (the stamp in tick() made it), so
        # the column is written in place rather than copying [N, U] again
        # (out of place under vmap, where index_copy_ has no batching rule).
        col = torch.where(hears, tick, fh.index_select(1, at)[:, 0])[:, None]
        if toolkit.is_batched(fh):
            state = state._replace(first_heard=fh.index_copy(1, at, col))
        else:
            fh.index_copy_(1, at, col)
    # an empty batch leaves the (inactive) slot's delta and birth as they
    # were, so a straight-line publish equals a skipped one bit for bit
    return state._replace(
        r_active=state.r_active.index_put((at,), any_ev.reshape(1)),
        r_delta=state.r_delta.index_put((at,), torch.where(any_ev, delta, state.r_delta[at])),
        r_birth=state.r_birth.index_put((at,), torch.where(any_ev, tick, state.r_birth[at])),
        truth_status=torch.where(subj_mask, new_status, state.truth_status),
        truth_inc=torch.where(subj_mask, new_inc, state.truth_inc),
        heard=state.heard | torch.where(hears[:, None], slot_words[None, :], 0),
    ), torch.where(hears, csum + delta, csum)


def _representative_accuser(accuser, subj_idx, partition, n: int) -> torch.Tensor:
    """[N] int32: per subject, one representative accuser, same-side
    accusers preferred (keys [0, n) same side, [n, 2n) cross side,
    scatter-min; ``subj_idx == n`` means none and lands in the dropped
    slot n).  Entries of non-subjects are garbage the caller masks."""
    ids = torch.arange(n, dtype=torch.int32, device=partition.device)
    same = accuser & (partition == partition.index_select(0, subj_idx.clamp(0, n - 1)))
    key = torch.where(same, ids, ids + n)
    rep_key = torch.full((n + 1,), 2 * n, dtype=torch.int32, device=partition.device)
    rep_key = rep_key.scatter_reduce(0, subj_idx.long(), key, "amin", include_self=True)[:n]
    rep_id = rep_key - (rep_key >= n).to(torch.int32) * n  # key in [0, 2n]
    return rep_id - (rep_id >= n).to(torch.int32) * n


def _publish_batch_gated(state, csum, slot, subj_mask, new_status, new_inc, hearer_mask,
                         tick, gate: bool = True):
    """Skip the whole publish when the subject set is empty."""
    return _phase(
        gate,
        subj_mask.any(),
        lambda st, c: _publish_batch(st, c, slot, subj_mask, new_status, new_inc,
                                     hearer_mask, tick),
        lambda st, c: (st, c),
        state,
        csum,
    )


def _subject_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[N] bool with True at each ``idx`` < n (``idx == n``: dropped)."""
    z = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    return z.index_fill(0, idx.long(), True)[:n]


# ---------------------------------------------------------------------------
# checksums


# [N] per-row sum of r_delta over the row's set bits, mod 2^32: an exact
# int64 sum (the JAX engine's limb matmul is exact only in full float32,
# which the TF32 matmul switch would break; this uses no float at all)
_bit_delta_sum = _exchange.delta_sum_plain


def compute_checksums(state: ScalableState, params: ScalableParams,
                      _chunk_rows: int = 65536) -> torch.Tensor:
    """checksum(i) = base_sum + sum over active rumors i heard of r_delta:
    the full O(N*U) recompute the incremental in-tick checksum must equal."""
    active_words = _pack_mask(state.r_active)
    return state.base_sum + _bit_delta_sum(
        state.heard & active_words[None, :], state.r_delta, _chunk_rows
    )


def farmhash_truth_checksum(state: ScalableState, universe, params: ScalableParams,
                            max_digits: int = 14, impl: Optional[str] = None) -> torch.Tensor:
    """Bit-exact FarmHash32 membership checksum of the truth view (every
    subject at its latest asserted status and incarnation), through the
    fused record encode and the stream hash (``impl``: "kernel", "plain"
    or None, by device).  Returns a [] int32 (uint32).  ``universe`` holds
    the cluster's addresses (sorted order = checksum string order)."""
    from ringpop_tpu_torch.ops import fused_checksum as fc

    n = params.n
    inc = state.truth_inc.to(torch.int64)
    inc_ms = torch.where(state.truth_inc > 0, params.epoch + (inc - 1) * 200, 0)
    rec_b, rec_l = fc.member_records(
        universe,
        torch.ones((1, n), dtype=torch.bool, device=inc.device),
        state.truth_status[None, :],
        inc_ms[None, :],
        max_digits,
    )
    return fc.fused_hash_rows(fc.pack_record_words(rec_b), rec_l, impl=impl)[0]


# ---------------------------------------------------------------------------
# obs planes


def _exchange_obs_update(exch, exch_hist, direct_ok, partner0, inv_base, n: int):
    """The single-device twin of the mesh plane's telemetry bumps: the
    S-shard routing of this tick's permutation, modelled analytically
    (every quantity is mask-independent except the delivered-row counts,
    which use the ``direct_ok`` that drives the trajectory).  The trips
    are priced against the default cap (``exchange_cap``).  Returns the new
    ``(exch, exch_hist)``; the bucket counts take one [N, S] bool
    temporary."""
    s = exch.shape[0]
    local = n // s
    dev = exch.device
    i32 = torch.int32
    shard_ids = torch.arange(s, dtype=i32, device=dev)

    def _bucket_counts(dest):
        # [S, S]: rows of source shard src addressed to shard dest // local
        ds = torch.div(dest, local, rounding_mode="floor").to(i32).reshape(s, local)
        return (ds[:, :, None] == shard_ids[None, None, :]).sum(dim=1, dtype=i32)

    cnt_pull = _bucket_counts(inv_base)  # pull: row p -> inv[p]
    cnt_push = _bucket_counts(partner0)  # push: row j -> partner0[j]
    cap = _exchange.exchange_cap(local, s)
    ovf_pull = (cnt_pull > cap).any().to(i32)
    ovf_push = (cnt_push > cap).any().to(i32)
    one = torch.ones(s, dtype=i32, device=dev)
    bump = torch.stack(
        [
            one,  # ticks
            one * (1 - ovf_pull),  # a2a_pull
            one * (1 - ovf_push),  # a2a_push
            one * ovf_pull,  # fallback_pull
            one * ovf_push,  # fallback_push
            direct_ok.reshape(s, local).sum(dim=1, dtype=i32),  # pull_rows
            direct_ok.index_select(0, inv_base).reshape(s, local).sum(dim=1, dtype=i32),
            (cnt_pull > 0).sum(dim=1, dtype=i32),  # dest_shards_pull
            (cnt_push > 0).sum(dim=1, dtype=i32),  # dest_shards_push
        ],
        dim=1,
    )
    # cap utilization: one observation per (shard, destination) bucket
    b_ids = torch.arange(hg.NBUCKETS, dtype=i32, device=dev)

    def _per_shard(cnt):
        idx = hg.bucket_index(cnt)
        return (idx[:, :, None] == b_ids[None, None, :]).sum(dim=1, dtype=i32)

    return exch + bump, exch_hist + torch.stack([_per_shard(cnt_pull), _per_shard(cnt_push)], dim=1)


def _column_bit_counts(words: torch.Tensor) -> torch.Tensor:
    """[N, W] int32 bit words -> [W*32] int32: per bit column b (word
    b // 32, bit b % 32), how many rows have it set — a per-bit sum over
    the words' bytes, with no [N, W*32] expansion."""
    b8 = u32.words_to_bytes(words)  # byte k of word w: bits 8k..8k+7
    cols = [((b8 >> j) & 1).sum(dim=0, dtype=torch.int32) for j in range(8)]
    return torch.stack(cols, dim=1).reshape(-1)


def _wavefront_update(fh, diff, reset_rows, reset_cols, t):
    """The new first-heard matrix: revived rows and recycled columns reset
    to -1, then every newly-set heard bit (``diff``) stamped ``t`` — the
    JAX engine's three ``where``s in one pass over row chunks."""
    n, u = fh.shape
    out = torch.empty_like(fh)
    bit = torch.bitwise_left_shift(
        torch.ones(WORD, dtype=torch.int64, device=fh.device),
        torch.arange(WORD, dtype=torch.int64, device=fh.device),
    )
    bit = u32.from_u64(bit)  # bit b of an int32 word
    rows = max(1, _WAVE_CHUNK // u)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        new_bits = (diff[lo:hi, :, None] & bit) != 0
        keep = fh[lo:hi].masked_fill(reset_rows[lo:hi, None] | reset_cols[None, :], -1)
        out[lo:hi] = torch.where(new_bits.reshape(hi - lo, u), t, keep)
    return out


# ---------------------------------------------------------------------------
# the tick


def tick(state: ScalableState, inputs: ChurnInputs, params: ScalableParams,
         exchange_plane=None):
    """One protocol period (the JAX engine's ``tick``, phase for phase).
    Returns ``(state, metrics)``; the input state is not modified."""
    if exchange_plane is not None:
        raise NotImplementedError(
            "the mesh exchange_plane seam is not ported yet (ROADMAP.md)"
        )
    n, u = params.n, params.u
    dev = state.heard.device
    gate = params.gate_phases
    t = state.tick_index + 1
    now = t + 1  # int32 stamp == epoch + t*200 ms
    rng = state.rng
    ids = torch.arange(n, dtype=torch.int32, device=dev)

    def take(x, idx):
        return x.index_select(0, idx)

    # ---- fault plane ---------------------------------------------------
    revived = inputs.revive & ~state.proc_alive
    rejoined = inputs.revive & state.proc_alive & ~state.gossip_on
    proc_alive = (state.proc_alive & ~inputs.kill) | inputs.revive
    gossip_on = (state.gossip_on | revived | rejoined) & proc_alive
    if inputs.partition is None:
        partition = state.partition
    else:
        partition = torch.where(inputs.partition >= 0, inputs.partition, state.partition)
    # a restarted process loses all pre-crash state
    state = state._replace(
        proc_alive=proc_alive,
        gossip_on=gossip_on,
        partition=partition,
        tick_index=t,
        heard=state.heard.masked_fill(revived[:, None], 0),
        susp_subject=state.susp_subject.masked_fill(revived, -1),
        susp_since=state.susp_since.masked_fill(revived, -1),
        defame_slot=state.defame_slot.masked_fill(revived, -1),
        defame_by=state.defame_by.masked_fill(revived, -1),
    )
    # a revived node's heard set is empty: its checksum is the base
    csum = torch.where(revived, state.base_sum, state.checksum)
    # obs planes: written straight-line (never inside a gated phase) into
    # these locals from the masks that drive the trajectory, attached at
    # the end
    hist = state.hist
    exch, exch_hist = state.exch, state.exch_hist

    # ---- rumor aging + slot recycling ----------------------------------
    live_count = proc_alive.sum()
    pow10 = torch.tensor([10**k for k in range(10)], dtype=torch.int64, device=dev)
    digits = (live_count >= pow10).sum(dtype=torch.int32)
    max_age = params.piggyback_factor * digits + params.age_slack
    aged = state.r_active & (t - state.r_birth > max_age)
    spt = slots_per_tick(params)
    slots = ((spt * (t - 1) + torch.arange(spt, dtype=torch.int32, device=dev)) % u).to(
        torch.int32
    )
    recycled = torch.zeros(u, dtype=torch.bool, device=dev).index_fill(0, slots.long(), True)
    retired = aged | (state.r_active & recycled)
    if hist is not None:
        # rumor age at retirement (r_birth is still pre-publish here)
        hist = hg.record(hist, SCALABLE_HIST_TRACKS.index("retired_age"),
                         t - state.r_birth, retired)
    # a defame pointer whose slot recycles now is demoted to -2
    ds0 = state.defame_slot
    state = state._replace(
        defame_slot=ds0.masked_fill((ds0 >= 0) & take(recycled, ds0.clamp(0, u - 1)), -2)
    )
    # fold retired deltas into the shared base
    retired_delta = torch.where(retired, state.r_delta, 0)
    base_sum = state.base_sum + u32.row_sum(retired_delta, dim=0)
    # a node that never heard a retiring rumor gains its delta with the base
    missing = _pack_mask(retired)[None, :] & ~state.heard
    csum = _phase(
        gate,
        (missing != 0).any(),
        lambda c: c + _bit_delta_sum(missing, retired_delta),
        lambda c: c,
        csum,
    )
    # recycled slots' stale heard bits vanish before reuse
    state = state._replace(
        r_active=state.r_active & ~retired,
        base_sum=base_sum,
        heard=state.heard & ~_pack_mask(recycled)[None, :],
    )

    # ---- gossip exchange: push-pull over K random pairings -------------
    # the K rounds' pairings are rotations of one fresh base permutation
    k_total = 1 + params.ping_req_size
    perm_impl = resolve_perm_impl(params, dev.type)
    base_perm, inv_base = _base_perm_pair(rng, n, perm_impl, salt=0xA11CE)
    offs = [(k * (n // k_total)) % n for k in range(k_total)]

    def _partner(k):
        if offs[k] == 0:
            return base_perm
        v = ids + offs[k]  # [0, 2n)
        return take(base_perm, torch.where(v >= n, v - n, v))

    def _inv(k):  # inv_k[v] = (inv_base[v] - c_k) mod n
        if offs[k] == 0:
            return inv_base
        v = inv_base - offs[k]  # (-n, n)
        return torch.where(v < 0, v + n, v)

    partner0 = base_perm
    # one loss outcome per (node, partner-round) message, shared by the
    # data plane and the failure-detection evidence
    losses = [_uniform(rng, (n,), salt=0xB0B0 + k) < params.packet_loss for k in range(k_total)]
    active_words = _pack_mask(state.r_active)
    gossiping = proc_alive & state.gossip_on
    conn0 = partition == take(partition, partner0)
    direct_ok = gossiping & take(proc_alive, partner0) & conn0 & ~losses[0]
    heard = state.heard
    # pull: i ORs its partner's row; push: the partner ORs i's row, a
    # gather by the inverse permutation
    pulled = torch.where(direct_ok[:, None], take(heard, partner0), 0) & active_words[None, :]
    pushed = (
        torch.where(take(direct_ok, inv_base)[:, None], take(heard, inv_base), 0)
        & active_words[None, :]
    )
    fused_ex = resolve_fused_exchange(params, dev.type)
    if fused_ex == "off":
        new_heard = heard | pulled | pushed
        d_direct = None
    elif fused_ex == "kernel":
        new_heard, d_direct, _ = _exchange.exchange(
            heard, pulled, pushed, state.r_delta, want_counts=False
        )
    else:
        new_heard, d_direct, _ = _exchange.exchange_plain(
            heard, pulled, pushed, state.r_delta, want_counts=False
        )
    if exch is not None:
        exch, exch_hist = _exchange_obs_update(exch, exch_hist, direct_ok, partner0, inv_base, n)
    heard_after_direct = new_heard

    # indirect rounds (the ping-req fanout) + probe evidence, only for
    # nodes whose direct ping failed
    need_ind = gossiping & ~direct_ok

    def _indirect(nh):
        any_responder = torch.zeros(n, dtype=torch.bool, device=dev)
        any_reached = torch.zeros(n, dtype=torch.bool, device=dev)
        for k in range(1, k_total):
            m = _partner(k)
            loss = losses[k]
            part_m = take(partition, m)
            conn = partition == part_m
            alive_m = take(proc_alive, m)
            use = need_ind & alive_m & conn & ~loss
            pulled_k = torch.where(use[:, None], take(nh, m), 0)
            inv = _inv(k)
            pushed_k = torch.where(take(use, inv)[:, None], take(nh, inv), 0)
            nh = nh | (pulled_k & active_words[None, :]) | (pushed_k & active_words[None, :])
            responder = alive_m & conn & ~loss
            # intermediary -> target probe leg: its own loss draw
            loss_probe = _uniform(rng, (n,), salt=0xD0DE + k) < params.packet_loss
            reached = (
                responder
                & take(proc_alive, partner0)
                & (part_m == take(partition, partner0))
                & ~loss_probe
            )
            any_responder = any_responder | responder
            any_reached = any_reached | reached
        return nh, any_responder, any_reached

    new_heard, any_responder, any_reached = _phase(
        gate,
        need_ind.any(),
        _indirect,
        lambda nh: (
            nh,
            torch.zeros(n, dtype=torch.bool, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev),
        ),
        new_heard,
    )

    # incremental checksum: every newly-set heard bit adds its delta (the
    # fused modes got the direct round's sum from the exchange)
    if fused_ex == "off":
        diff = new_heard ^ heard
    else:
        csum = csum + d_direct
        diff = new_heard ^ heard_after_direct
    csum = _phase(
        gate,
        (diff != 0).any(),
        lambda c: c + _bit_delta_sum(diff, state.r_delta),
        lambda c: c,
        csum,
    )
    if state.first_heard is not None or hist is not None:
        diff_all = new_heard ^ heard  # every bit that turned on this tick
        if state.first_heard is not None:
            state = state._replace(first_heard=_wavefront_update(
                state.first_heard, diff_all, revived, recycled, t
            ))
        if hist is not None:
            # rumor age at first-heard: column r's new bits, at age t - r_birth[r]
            hist = hg.record_weighted(hist, SCALABLE_HIST_TRACKS.index("rumor_age"),
                                      t - state.r_birth, _column_bit_counts(diff_all))
    state = state._replace(heard=new_heard)

    # ---- failure detection: suspect batch ------------------------------
    # cancel clocks whose subject is no longer suspect in truth
    cancel = (state.susp_subject >= 0) & (
        take(state.truth_status, state.susp_subject.clamp(0, n - 1)) != SUSPECT
    )
    if hist is not None:
        # suspicion duration at refute-cancel (the clock read before reset)
        hist = hg.record(hist, SCALABLE_HIST_TRACKS.index("suspicion_duration"),
                         t - state.susp_since, cancel)
    state = state._replace(
        susp_subject=state.susp_subject.masked_fill(cancel, -1),
        susp_since=state.susp_since.masked_fill(cancel, -1),
    )
    # evidence: the direct exchange failed and the ping-req fanout's
    # intermediaries answered but none reached the target
    direct_fail = gossiping & ~direct_ok & (partner0 != ids)
    start_susp = direct_fail & any_responder & ~any_reached & (state.susp_subject != partner0)
    state = state._replace(
        susp_subject=torch.where(start_susp, partner0, state.susp_subject),
        susp_since=torch.where(start_susp, t, state.susp_since),
    )
    already_down = take(state.truth_status, partner0.clamp(0, n - 1)) >= SUSPECT
    detector = start_susp & ~already_down
    subj_idx = torch.where(detector, partner0, n)
    suspect_subjects = _subject_mask(subj_idx, n)
    n_susp = suspect_subjects.sum(dtype=torch.int32)
    rep_id = _representative_accuser(detector, subj_idx, partition, n)
    state, csum = _publish_batch_gated(
        state, csum, slots[0], suspect_subjects,
        torch.full((n,), SUSPECT, dtype=torch.int32, device=dev),
        state.truth_inc,  # suspect keeps the member's incarnation
        detector, t, gate=gate,
    )
    state = state._replace(
        defame_slot=torch.where(suspect_subjects, slots[0], state.defame_slot),
        defame_by=torch.where(suspect_subjects, rep_id, state.defame_by),
    )

    # ---- suspicion expiry: faulty batch --------------------------------
    expire = (
        (state.susp_since >= 0)
        & (t - state.susp_since >= params.suspicion_ticks)
        & proc_alive
    )
    if hist is not None:
        # suspicion duration at expiry (a cancelled clock was reset above)
        hist = hg.record(hist, SCALABLE_HIST_TRACKS.index("suspicion_duration"),
                         t - state.susp_since, expire)
    still_suspect = take(state.truth_status, state.susp_subject.clamp(0, n - 1)) == SUSPECT
    expirer = expire & still_suspect & (state.susp_subject >= 0)
    fs_idx = torch.where(expirer, state.susp_subject, n)
    faulty_subjects = _subject_mask(fs_idx, n)
    n_faulty = faulty_subjects.sum(dtype=torch.int32)
    frep_id = _representative_accuser(expirer, fs_idx, partition, n)
    state = state._replace(
        susp_subject=state.susp_subject.masked_fill(expire, -1),
        susp_since=state.susp_since.masked_fill(expire, -1),
    )
    state, csum = _publish_batch_gated(
        state, csum, slots[1], faulty_subjects,
        torch.full((n,), FAULTY, dtype=torch.int32, device=dev),
        state.truth_inc,  # faulty with current incarnation (suspicion.js:67-70)
        expirer, t, gate=gate,
    )
    state = state._replace(
        defame_slot=torch.where(faulty_subjects, slots[1], state.defame_slot),
        defame_by=torch.where(faulty_subjects, frep_id, state.defame_by),
    )

    # ---- refute + rejoin: alive batch ----------------------------------
    # a live node that heard the rumor defaming it, and can reach its
    # representative defamer, re-asserts alive (member.js:76-81)
    ds = state.defame_slot
    ds_c = ds.clamp(0, u - 1)
    word = state.heard.gather(1, torch.div(ds_c, WORD, rounding_mode="floor").long()[:, None])[:, 0]
    heard_bit = (word >> (ds_c % WORD)) & 1
    aware = (ds == -2) | ((ds >= 0) & ((heard_bit != 0) | ~take(state.r_active, ds_c)))
    db = state.defame_by
    reachable = (db >= 0) & (take(partition, db.clamp(0, n - 1)) == partition)
    defamed = (state.truth_status == SUSPECT) | (state.truth_status == FAULTY)
    refuter = proc_alive & ~revived & aware & reachable & defamed
    n_refute = refuter.sum(dtype=torch.int32)
    alive_subjects = revived | rejoined | refuter
    state, csum = _publish_batch_gated(
        state, csum, slots[2], alive_subjects,
        torch.full((n,), ALIVE, dtype=torch.int32, device=dev),
        now.expand(n),  # fresh incarnation (member.js:78-81)
        alive_subjects, t, gate=gate,
    )
    state = state._replace(
        defame_slot=state.defame_slot.masked_fill(alive_subjects, -1),
        defame_by=state.defame_by.masked_fill(alive_subjects, -1),
    )

    # ---- graceful leave: leave batch -----------------------------------
    if inputs.leave is not None:
        if not params.enable_leave:
            raise ValueError(
                "leave inputs require ScalableParams(enable_leave=True) "
                "(allocates the 4th rumor slot)"
            )
        leaver = (
            inputs.leave & proc_alive & state.gossip_on & (state.truth_status != LEAVE)
        )
        n_leave = leaver.sum(dtype=torch.int32)
        state, csum = _publish_batch_gated(
            state, csum, slots[3], leaver,
            torch.full((n,), LEAVE, dtype=torch.int32, device=dev),
            state.truth_inc, leaver, t, gate=gate,
        )
        # a departed node stops gossip and suspicion wholesale
        state = state._replace(
            gossip_on=state.gossip_on & ~leaver,
            susp_subject=state.susp_subject.masked_fill(leaver, -1),
            susp_since=state.susp_since.masked_fill(leaver, -1),
        )
    else:
        n_leave = torch.zeros((), dtype=torch.int32, device=dev)

    # ---- checksums + metrics ------------------------------------------
    if params.checksum_in_tick:
        # every mutation applied its exact delta: csum == compute_checksums
        checksum = csum
        view_sig = csum
    else:
        # checksums on demand; the active heard-set fingerprints the view
        checksum = state.checksum
        hw = state.heard & _pack_mask(state.r_active)[None, :]
        pos = torch.arange(hw.shape[1], dtype=torch.int32, device=dev)[None, :]
        m = hw * u32.s32(0x9E3779B1) + pos * u32.s32(0x85EBCA77)
        m = m ^ u32.srl(m, 15)
        view_sig = u32.row_sum(m * u32.s32(0x2C1B3C6D), dim=1)
    state = state._replace(checksum=checksum, rng=_fold(rng, 0x5CA1E), hist=hist, exch=exch,
                           exch_hist=exch_hist)

    active_words2 = _pack_mask(state.r_active)
    n_active = state.r_active.sum(dtype=torch.int32)
    hw_all = state.heard & active_words2[None, :]
    full_cov = ((hw_all == active_words2[None, :]) | ~proc_alive[:, None]).all()

    def _mean_frac(_):
        heard_counts = _exchange.popcount_u32(hw_all).sum(dim=1, dtype=torch.int32)
        frac = torch.where(
            n_active > 0,
            heard_counts.to(torch.float32) / n_active.clamp(min=1).to(torch.float32),
            1.0,
        )
        return _xla_mean_f32(torch.where(proc_alive, frac, 1.0))

    mean_frac = _phase(
        gate, ~full_cov, _mean_frac,
        lambda _: torch.ones((), dtype=torch.float32, device=dev), None,
    )

    # distinct view count: the sort runs only when live fingerprints
    # differ.  lo/hi are unsigned (through the sign flip); the sort may be
    # signed, since the count needs only equal values adjacent.
    cs = torch.where(proc_alive, view_sig, _U32_ALL)
    any_live = proc_alive.any()
    flipped = view_sig ^ _I32_MIN
    lo = torch.where(proc_alive, flipped, _I32_MAX).min()
    hi = torch.where(proc_alive, flipped, _I32_MIN).max()

    def _distinct_sorted(c):
        s = torch.sort(c).values
        return (
            ((s[1:] != s[:-1]) & (s[1:] != _U32_ALL)).sum(dtype=torch.int32)
            + (s[0] != _U32_ALL).to(torch.int32)
        )

    distinct = _phase(
        gate,
        (lo != hi) & any_live,
        _distinct_sorted,
        lambda c: (any_live & (hi != _I32_MAX)).to(torch.int32),
        cs,
    )

    metrics = ScalableMetrics(
        live_nodes=proc_alive.sum(dtype=torch.int32),
        active_rumors=n_active,
        mean_heard_frac=mean_frac,
        full_coverage=full_cov,
        distinct_checksums=distinct,
        suspects_published=n_susp,
        faulties_published=n_faulty,
        refutes_published=n_refute,
        leaves_published=n_leave,
        pings_sent=gossiping.sum(dtype=torch.int32),
        pings_delivered=direct_ok.sum(dtype=torch.int32),
        ping_req_inconclusive=(direct_fail & ~any_responder).sum(dtype=torch.int32),
        rumors_retired=retired.sum(dtype=torch.int32),
    )
    return state, metrics
