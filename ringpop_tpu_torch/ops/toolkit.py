"""Shared pieces of the port's fused ops.

Counterpart of ``ringpop_tpu/ops/toolkit.py`` (lines 64-171 and the twin
registry at :340): knob resolution and its run-log note
(:func:`resolution_note`, :func:`emit_resolution`), the packed bool-row
bitmask helpers, the segment reduction, and :data:`TWIN_REGISTRY` — one row per CUDA kernel of the port naming its
wrapper, its plain PyTorch version, the JAX function it is held against
and the test that holds it — and the batch axis shared by every kernel
wrapper (:func:`is_batched`, :func:`batch_front`): inside
``torch.func.vmap`` a wrapper routes its functorch ``BatchedTensor``
operands through a ``torch.library.custom_op`` of namespace :data:`LIB`
whose ``register_vmap`` rule launches the kernel once for all B clusters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


def resolve_impl(
    knob: str,
    requested: str,
    device_type: str,
    *,
    auto: dict,
    allowed: Sequence[str],
) -> str:
    """Resolve a fused-op knob to a concrete impl: anything but "auto" is
    honored after validation against ``allowed``; "auto" is looked up in
    the ``auto`` table by device type ("*" is the fallback row)."""
    if requested != "auto":
        if requested not in allowed:
            raise ValueError(
                "%s must be auto|%s, got %r" % (knob, "|".join(allowed), requested)
            )
        return requested
    return auto.get(device_type, auto["*"])


def resolution_note(
    knob: str,
    requested: str,
    resolved: str,
    backend: str,
    single_device_resolution: Optional[str] = None,
    **extra,
) -> dict:
    """The run-log-ready resolution dict of a fused-op knob (the JAX
    toolkit's shape): what was asked, what it resolved to on ``backend``,
    and whether an "auto" request diverged from the single-device pick."""
    sdr = resolved if single_device_resolution is None else single_device_resolution
    note = {
        "knob": knob,
        "requested": requested,
        "impl": resolved,
        "backend": backend,
        "single_device_resolution": sdr,
        "differs_from_single_device": requested == "auto" and resolved != sdr,
    }
    note.update(extra)
    return note


def emit_resolution(note: dict, recorder=None, statsd=None, *,
                    event: str = "op_resolution", gauge_prefix: Optional[str] = None) -> None:
    """Publish a resolution note as one run-log event row on ``recorder``
    (an ``obs.recorder.RunRecorder``) and, with ``gauge_prefix``, the JAX
    toolkit's statsd gauges on ``statsd`` (an ``obs.statsd_bridge.
    StatsdBridge``): ``<prefix>.resolution_differs`` 1/0, plus
    ``<prefix>.cap`` when the note carries a static cap.  Either sink may
    be None."""
    if recorder is not None:
        recorder.record_event(event, **note)
    if statsd is not None and gauge_prefix is not None:
        statsd.gauge("%s.resolution_differs" % gauge_prefix,
                     int(bool(note.get("differs_from_single_device", False))))
        if note.get("cap") is not None:
            statsd.gauge("%s.cap" % gauge_prefix, int(note["cap"]))


# the namespace of the port's custom ops (``torch.ops.ringpop_torch.*``)
LIB = "ringpop_torch"


def is_batched(*tensors) -> bool:
    """True when any operand is a functorch ``BatchedTensor``: the caller
    runs inside ``torch.func.vmap``, whose tensors have no storage a
    kernel could read."""
    return any(
        isinstance(t, torch.Tensor) and torch._C._functorch.is_batchedtensor(t)
        for t in tensors
    )


def unbatched(t: torch.Tensor) -> torch.Tensor:
    """The tensor under every ``torch.func.vmap`` level of ``t`` (``t``
    itself outside vmap): its shape holds the batch axes too."""
    while torch._C._functorch.is_batchedtensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def leads_contiguous(t: torch.Tensor) -> bool:
    """True when every ``torch.func.vmap`` level of ``t`` keeps its batch
    axis first over contiguous storage: ``t``'s rows are then contiguous
    in memory too, so a reinterpreting view of them is valid."""
    while torch._C._functorch.is_batchedtensor(t):
        if torch._C._functorch.maybe_get_bdim(t) != 0:
            return False
        t = torch._C._functorch.get_unwrapped(t)
    return t.is_contiguous()


def view_storage(t: torch.Tensor, fn):
    """``fn`` (a view of the trailing axes, such as ``view(dtype)``) applied
    to the storage under every ``torch.func.vmap`` level of ``t``, and the
    result wrapped back at the same levels, batch axis first.  For a ``t``
    of which :func:`leads_contiguous` holds: functorch has no batching
    rule for some views (``view.dtype``)."""
    levels = []
    while torch._C._functorch.is_batchedtensor(t):
        levels.append(torch._C._functorch.maybe_get_level(t))
        t = torch._C._functorch.get_unwrapped(t)
    out = fn(t)
    for level in reversed(levels):
        out = torch._C._functorch._add_batch_dim(out, 0, level)
    return out


def batch_front(t: Optional[torch.Tensor], dim: Optional[int], b: int) -> Optional[torch.Tensor]:
    """A vmap rule's operand with its batch axis first: ``[B, ...]``.  An
    operand that is not batched (``dim`` None) is expanded, a stride-0
    view that costs no copy until a kernel needs it contiguous."""
    if t is None:
        return None
    if dim is None:
        return t.expand(b, *t.shape)
    return t.movedim(dim, 0)


def packed_width(n_cols: int) -> int:
    """Words per row of a :func:`pack_bool_rows` bitmask."""
    return -(-n_cols // 32)


def pack_bool_rows(mask: torch.Tensor) -> torch.Tensor:
    """[..., N, M] bool -> [..., N, ceil(M/32)] int32 (uint32) row bitmask,
    bit c%32 of word c//32 = mask[..., c]."""
    pad = (-mask.shape[-1]) % 32
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    w = mask.reshape(mask.shape[:-1] + (-1, 32)).to(torch.int64)
    bits = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=mask.device),
        torch.arange(32, dtype=torch.int64, device=mask.device),
    )
    packed = (w * bits).sum(dim=-1, dtype=torch.int64)  # distinct bits: the sum is the OR
    return ((packed ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def segment_reduce(values, seg, n: int, reduce: str, identity: int) -> torch.Tensor:
    """``jax.ops.segment_{max,min}(values, seg, num_segments=n+1)[:n]`` for
    [R, C] int32 ``values`` and [R] segment ids in [0, n]: segment n is
    dropped."""
    out = torch.full((n + 1, values.shape[1]), identity, dtype=values.dtype, device=values.device)
    idx = seg.to(torch.int64)[:, None].expand(values.shape)
    return out.scatter_reduce(0, idx, values, reduce, include_self=True)[:n]


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per int32 (uint32) word."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


@dataclasses.dataclass(frozen=True)
class KernelTwin:
    """One CUDA kernel of the port and what holds it.

    ``module``: ``ringpop_tpu_torch.ops`` module of the wrapper;
    ``kernel_entry``: the wrapper that launches ``source``;
    ``plain_entry``: its plain PyTorch version in the same module;
    ``jax_entry``: the JAX function (``module:function``) the plain version
    is held against on the CPU; ``gate_test``: the test file doing that;
    ``replaces``: the Pallas kernel's file:line (for a kernel that replaces
    none, the JAX function it stands in for); ``also_replaces``: other
    Pallas kernels the same CUDA kernel stands for; ``batch_gate_test``:
    the test holding the kernel's batching rule (the custom op
    ``torch.ops.ringpop_torch.<kernel_entry>``, which launches the kernel
    once for B clusters under ``torch.func.vmap``) against the plain
    version per cluster."""

    module: str
    kernel_entry: str
    plain_entry: str
    source: str
    jax_entry: str
    gate_test: str
    replaces: str
    also_replaces: Tuple[str, ...] = ()
    batch_gate_test: str = "tests/test_torch_vmap_rules.py"


TWIN_REGISTRY: Tuple[KernelTwin, ...] = (
    KernelTwin(
        "fused_apply",
        "apply_updates",
        "apply_updates_plain",
        "ringpop_tpu_torch/csrc/apply_updates.cu",
        "ringpop_tpu.ops.fused_apply:apply_updates_xla",
        "tests/test_torch_fused_ops.py",
        "ringpop_tpu/ops/fused_apply.py:165",
    ),
    KernelTwin(
        "fused_piggyback",
        "pb_budget",
        "pb_budget_plain",
        "ringpop_tpu_torch/csrc/pb_budget.cu",
        "ringpop_tpu.ops.fused_piggyback:pb_budget_xla",
        "tests/test_torch_fused_ops.py",
        "ringpop_tpu/ops/fused_piggyback.py:79",
    ),
    KernelTwin(
        "stream_hash",
        "fused_stream",
        "fused_stream_plain",
        "ringpop_tpu_torch/csrc/fused_stream.cu",
        "ringpop_tpu.ops.pallas_farmhash:fused_stream_xla",
        "tests/test_torch_hash.py",
        "ringpop_tpu/ops/pallas_farmhash.py:243",
    ),
    KernelTwin(
        "exchange",
        "exchange",
        "exchange_plain",
        "ringpop_tpu_torch/csrc/exchange.cu",
        "ringpop_tpu.ops.exchange:exchange_xla",
        "tests/test_torch_exchange.py",
        "ringpop_tpu/ops/exchange.py:82",
    ),
    KernelTwin(
        "block_loop",
        "block_loop",
        "block_loop_plain",
        "ringpop_tpu_torch/csrc/block_loop.cu",
        "ringpop_tpu.ops.pallas_farmhash:block_loop",
        "tests/test_torch_block_loop.py",
        "ringpop_tpu/ops/pallas_farmhash.py:36",
        ("ringpop_tpu/ops/pallas_farmhash.py:429",),
    ),
    # replaces no Pallas kernel: it stands in for XLA's elementwise encode
    KernelTwin(
        "fused_checksum",
        "member_records",
        "member_records_plain",
        "ringpop_tpu_torch/csrc/member_records.cu",
        "ringpop_tpu.ops.fused_checksum:member_records",
        "tests/test_torch_hash.py",
        "ringpop_tpu/ops/fused_checksum.py:113",
    ),
    # replaces no Pallas kernel: it stands in for the JAX engine's
    # while_loop walk
    KernelTwin(
        "prp_walk",
        "prp_walk",
        "prp_walk_plain",
        "ringpop_tpu_torch/csrc/prp_walk.cu",
        "ringpop_tpu.models.sim.engine_scalable:_prp_perm",
        "tests/test_torch_prp_walk.py",
        "ringpop_tpu/models/sim/engine_scalable.py:484",
    ),
    # replace no Pallas kernel: the four pieces stand in for the JAX
    # engine's ping-req phase, held through the engine's tick
    *(
        KernelTwin(
            "ping_req",
            entry,
            entry + "_plain",
            "ringpop_tpu_torch/csrc/%s.cu" % entry,
            "ringpop_tpu.models.sim.engine:tick",
            "tests/test_torch_ping_req.py",
            "ringpop_tpu/models/sim/engine.py:2031",
            batch_gate_test="tests/test_torch_ping_req.py",
        )
        for entry in ("ping_req_select", "ping_req_combine", "ping_req_hits", "ping_req_respond")
    ),
)
