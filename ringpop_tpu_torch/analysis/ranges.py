"""Interval ranges over a recorded entry point: the numeric half of the
scale certifier.

Counterpart of ``ringpop_tpu/analysis/ranges.py``.  JAX's interpreter walks
a jaxpr; the port has no graph, so :class:`RangeInterpreter` walks a
:class:`~ringpop_tpu_torch.analysis.dataflow.Recording` made with
``detail`` (each op's shapes, its non-tensor arguments, the concrete range
of every value made from no tensor input), one transfer function per aten
op, and reports every op whose integer result can escape its dtype.

Domain
------
A value is ``None`` (unknown: floats, unmodelled ops) or an
:class:`Interval` of Python ints, a ``None`` endpoint meaning ±∞.  The
interval algebra, the widening with thresholds and the declared envelopes
are copies of JAX's (``union``, ``widen``, the ``iv_*`` functions,
``TICK_CEILING``, ``N_MAX_PODS``, ...); tests/test_torch_analysis_ranges.py
holds them equal on seeded random intervals.  ``torch.empty`` gives the
bottom value, so a buffer written after it takes the written range.
Inputs seed from the declared contract (:func:`input_contract`): bools
[0, 1], signed lanes [-2, 2^20] (the -1/-2 sentinels up to the serving
envelope's tick ceiling), and the uint32 lanes full range.

The uint32 lanes
----------------
The port keeps every uint32 as int32 storage (``ops/u32.py``), so a hash
multiply "escapes" int32 on every round, where JAX's dtype said wrap.  The
port declares what the dtype said: per state class the fields JAX stores
as uint32, seeded with the whole int32 range of bit patterns
(``engine.SIM_UINT32_FIELDS`` and its siblings, gathered by
:func:`uint32_fields`), and :data:`WRAP_CONTRACT`, the functions whose
int32 arithmetic wraps mod 2^32 by contract (the farmhash, record-mix and
fused-checksum paths, the bit packing, the counter RNGs and the PRP's
round function), each with its reason: an escape there wraps, and an
index mixed there becomes bits, not an index.  Ops on bit patterns that
are already full range (``ops/u32.py``, threefry, the stream hash over
its carries) make no new escape and need no row.  An escape in
such a module wraps silently, as JAX's unsigned lanes do; a row that
suppresses nothing is a ``stale-allowlist`` finding (the ``overflow``
prong).

Scale model
-----------
:class:`ScaleSpec` says per entry how the toy dims extrapolate: a dim equal
to ``c * toy_n`` scales to ``c * n_max``, and ``dim_map`` pins toy dims
that coincide with ``c * 8`` but do not ride the N axis (the rumor table
``u`` = 128 and its word width 4, the farmhash row width 64, the block
loop's 4 rounds of 5 words), as JAX pins them.  Pins were chosen over
recording at two sizes and classifying a dim by whether it moved: one
recording per entry is shared with ``graph`` and ``noninterference``, and
a second size would double every prong's recording time.

One branch per recording
------------------------
A recording holds the branch its inputs took, where a jaxpr holds both
arms of every ``cond``: a range proved here is proved for that path only
(PERF.md §7).  The registry's entries start from states that take the
churn branches (a kill in the first tick).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ringpop_tpu_torch.analysis import dataflow

__all__ = [
    "Interval",
    "RangeEvent",
    "ScaleSpec",
    "RangeInterpreter",
    "analyze",
    "input_contract",
    "entry_scale",
    "scaled_dim",
    "buffer_poly",
    "poly_bytes",
    "feasible_n",
    "TICK_CEILING",
    "N_MAX_PODS",
    "ENTRY_SCALES",
    "uint32_fields",
    "WRAP_CONTRACT",
]

# ---------------------------------------------------------------------------
# declared contracts: the envelopes the certifier proves against (JAX's)

TICK_CEILING = 1 << 20  # long-running serving, ~2.4 days of 200 ms ticks
N_MAX_PODS = 64 << 20  # the 64Mi-node pod-scale ceiling
FULL_N_MAX = 1 << 16  # full-fidelity [N, N]-plane engine ceiling
ROUTE_N_MAX = 16 << 20  # routing plane ceiling
HASH_ROWS_MAX = 1 << 20  # checksum/farmhash row-batch ceiling
U_ENVELOPE = 512  # ScalableParams.u default: rumor table capacity
SENTINEL_LO = -2  # the -1/-2 "never"/"tombstone" stamp sentinels


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed integer interval; a ``None`` endpoint is ±∞."""

    lo: Optional[int]
    hi: Optional[int]

    def __repr__(self) -> str:
        lo = "-inf" if self.lo is None else str(self.lo)
        hi = "+inf" if self.hi is None else str(self.hi)
        return f"[{lo}, {hi}]"


def point(v: int) -> Interval:
    return Interval(int(v), int(v))


FULL = Interval(None, None)
BOOL = Interval(0, 1)


def _min(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None or b is None:
        return None
    return min(a, b)


def _max(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None or b is None:
        return None
    return max(a, b)


def union(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    """Precise union (no widening) — top absorbs."""
    if a is None or b is None:
        return None
    return Interval(_min(a.lo, b.lo), _max(a.hi, b.hi))


# widening thresholds: a carry bound that grows between ticks jumps
# outward to the next landmark instead of inching forever
_HI_LANDMARKS: Tuple[Optional[int], ...] = (
    0,
    1,
    (1 << 8) - 1,
    (1 << 16) - 1,
    TICK_CEILING,
    (1 << 31) - 1,
    (1 << 32) - 1,
    (1 << 63) - 1,
    None,
)
_LO_LANDMARKS: Tuple[Optional[int], ...] = (
    0,
    SENTINEL_LO,
    -TICK_CEILING,
    -(1 << 31),
    -(1 << 63),
    None,
)


def _widen_hi(v: Optional[int]) -> Optional[int]:
    if v is None:
        return None
    for lm in _HI_LANDMARKS:
        if lm is None or v <= lm:
            return lm
    return None


def _widen_lo(v: Optional[int]) -> Optional[int]:
    if v is None:
        return None
    for lm in _LO_LANDMARKS:
        if lm is None or v >= lm:
            return lm
    return None


def widen(old: Optional[Interval], new: Optional[Interval]) -> Optional[Interval]:
    """``old ∇ (old ∪ new)``: keep stable bounds, jump grown ones to the
    next landmark.  A fixpoint in O(#landmarks) rounds."""
    if old is None or new is None:
        return None
    u = union(old, new)
    lo = u.lo if (old.lo is not None and u.lo == old.lo) else _widen_lo(u.lo)
    if old.lo is None:
        lo = None
    hi = u.hi if (old.hi is not None and u.hi == old.hi) else _widen_hi(u.hi)
    if old.hi is None:
        hi = None
    return Interval(lo, hi)


# ---------------------------------------------------------------------------
# dtypes (as torch.dtype or its str, "torch.int32")

_INT_BITS = {
    "int8": (8, True), "int16": (16, True), "int32": (32, True), "int64": (64, True),
    "uint8": (8, False), "uint16": (16, False), "uint32": (32, False), "uint64": (64, False),
}


def _dname(dt) -> str:
    return str(dt).replace("torch.", "")


def dtype_interval(dt) -> Optional[Interval]:
    """Representable range of an integer or bool dtype; None for floats
    and anything else (unranged)."""
    name = _dname(dt)
    if name == "bool":
        return BOOL
    bits = _INT_BITS.get(name)
    if bits is None:
        return None
    n, signed = bits
    if signed:
        return Interval(-(1 << (n - 1)), (1 << (n - 1)) - 1)
    return Interval(0, (1 << n) - 1)


def _is_signed(dt) -> bool:
    bits = _INT_BITS.get(_dname(dt))
    return bits is not None and bits[1]


def _is_int_like(dt) -> bool:
    name = _dname(dt)
    return name == "bool" or name in _INT_BITS


def _itemsize(dt) -> int:
    name = _dname(dt)
    if name == "bool":
        return 1
    bits = _INT_BITS.get(name)
    if bits is not None:
        return bits[0] // 8
    return {"float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
            "complex64": 8, "complex128": 16}.get(name, 4)


def input_contract(dtype, uint32_lane: bool = False) -> Optional[Interval]:
    """The declared contract of one entry input leaf: bools [0, 1], the
    uint32 lanes (int32 bit patterns) and unsigned dtypes full range,
    other signed lanes the sentinels up to the tick ceiling."""
    name = _dname(dtype)
    if name == "bool":
        return BOOL
    if name not in _INT_BITS:
        return None
    if uint32_lane or not _is_signed(name):
        return dtype_interval(name)
    return Interval(SENTINEL_LO, TICK_CEILING)


# ---------------------------------------------------------------------------
# the declared per-entry scale model


@dataclasses.dataclass(frozen=True)
class ScaleSpec:
    """How one entry's toy dims extrapolate: a dim equal to ``c * toy_n``
    (``c`` in ``coeffs``) scales to ``c * n_max``; ``dim_map`` pins toy dims
    to their declared envelope and wins over the coefficients; any other
    dim is a constant."""

    toy_n: int = 8
    n_max: int = N_MAX_PODS
    coeffs: Tuple[int, ...] = (1,)
    dim_map: Tuple[Tuple[int, int], ...] = ()

    def label(self) -> str:
        return f"toy_n={self.toy_n} n_max={self.n_max}"


def _dim_rule(d: int, spec: ScaleSpec) -> Tuple[str, int]:
    """``("pinned", env)``, ``("scaled", c)`` or ``("const", d)``."""
    for toy, env in spec.dim_map:
        if d == toy:
            return "pinned", env
    for c in spec.coeffs:
        if c > 0 and d == c * spec.toy_n:
            return "scaled", c
    return "const", d


def scaled_dim(d: int, spec: ScaleSpec) -> int:
    """The declared at-scale extent of one toy dim."""
    kind, v = _dim_rule(d, spec)
    if kind == "pinned":
        return v
    if kind == "scaled":
        return v * spec.n_max
    return d


# the scalable engine's rumor table u = 128 and its 4 words stay at the
# capacity envelope; 32 is the bit-lane axis of a word
_SCALABLE_DIMS = ((128, U_ENVELOPE), (4, U_ENVELOPE // 32), (32, 32))
# the farmhash entries' 64-byte rows and the block loop's 4 rounds of 5
# words are per-row widths, not rows
_HASH_DIMS = ((64, 64), (4, 4))

# first match wins; the port's entry names (graph_audit.DEFAULT_ENTRIES)
ENTRY_SCALES: Tuple[Tuple[str, ScaleSpec], ...] = (
    # the full engine's [N, N] planes: the full-engine ceiling
    ("engine-tick*", ScaleSpec(8, FULL_N_MAX)),
    ("batched-tick", ScaleSpec(8, FULL_N_MAX)),
    ("fused-apply-*", ScaleSpec(8, FULL_N_MAX)),
    ("fused-piggyback-*", ScaleSpec(8, FULL_N_MAX)),
    ("fuzz-scan-full", ScaleSpec(8, FULL_N_MAX)),
    ("checkpoint-restore", ScaleSpec(8, FULL_N_MAX)),
    # the scalable engine and the exchange: N to the pod ceiling, u and w
    # at the capacity envelope
    ("engine-scalable-*", ScaleSpec(8, N_MAX_PODS, dim_map=_SCALABLE_DIMS)),
    ("fuzz-scan-scalable", ScaleSpec(8, N_MAX_PODS, dim_map=_SCALABLE_DIMS)),
    ("exchange*", ScaleSpec(8, N_MAX_PODS, dim_map=_SCALABLE_DIMS)),
    # row-batched hash pipelines: rows scale, widths are constant
    ("fused-stream-*", ScaleSpec(8, HASH_ROWS_MAX, dim_map=_HASH_DIMS)),
    ("block-loop-*", ScaleSpec(8, HASH_ROWS_MAX, dim_map=_HASH_DIMS)),
    ("farmhash-*", ScaleSpec(8, HASH_ROWS_MAX, dim_map=_HASH_DIMS)),
    ("fused-checksum-*", ScaleSpec(8, HASH_ROWS_MAX)),
    # the ring and the routing plane: N members x 100 replica points, the
    # flat ring (toy 800) riding the N axis with coefficient 100
    ("ring-device-lookup", ScaleSpec(8, ROUTE_N_MAX, coeffs=(1, 100))),
    ("route-*", ScaleSpec(8, ROUTE_N_MAX, coeffs=(1, 100))),
    ("*", ScaleSpec(8, N_MAX_PODS)),
)


def entry_scale(name: str) -> ScaleSpec:
    for pat, spec in ENTRY_SCALES:
        if fnmatch.fnmatchcase(name, pat):
            return spec
    return ScaleSpec()


def uint32_fields() -> Dict[str, frozenset]:
    """State class -> the fields JAX holds as uint32 (each registry sits
    beside its class)."""
    from ringpop_tpu_torch.models.route import plane
    from ringpop_tpu_torch.models.sim import engine, engine_scalable as es

    return {
        "SimState": engine.SIM_UINT32_FIELDS,
        "ScalableState": es.SCALABLE_UINT32_FIELDS,
        "RouteState": plane.ROUTE_UINT32_FIELDS,
    }


# Modules whose int32 arithmetic wraps mod 2^32 by contract: ops whose
# innermost port frame (``module.py:function``, fnmatch) matches a key
# wrap silently on escape, as JAX's uint32 lanes do.
WRAP_CONTRACT: Dict[str, str] = {
    "ops/farmhash.py:*": (
        "farmhashmk's mixing (Fetch32 byte assembly, the c1/c2 multiplies, "
        "fmix): uint32 arithmetic in JAX, the same bits in int32 here"
    ),
    "ops/block_loop.py:*": "the farmhash block loop's plain version: uint32 in JAX",
    "ops/record_mix.py:*": (
        "record-mix hashing of membership records (the fast checksums): uint32 "
        "in JAX"
    ),
    "ops/fused_checksum.py:*": (
        "the fused checksum's word packing and stream carries: uint32 in JAX"
    ),
    "ops/toolkit.py:pack_bool_rows": (
        "bool rows packed into uint32 words: the int64 sum of distinct bits is "
        "their OR, narrowed to the word's int32 bit pattern"
    ),
    "models/sim/engine.py:_uniform": (
        "the full engine's counter RNG: the draw counter j (an index) mixed as "
        "base + j * 0x01000193 and onward into uint32 bits, not an index"
    ),
    "models/sim/engine_scalable.py:_rand_u32": (
        "the scalable engine's counter RNG: the flat-index counter mixed as "
        "key + i * 0x01000193 and onward into uint32 bits, not an index"
    ),
    "ops/prp_walk.py:feistel_f": (
        "the PRP's Feistel round function (lowbias32-style multiplies): "
        "uint32 in JAX"
    ),
    "ops/ping_req.py:select_scores": (
        "the full engine's counter RNG at the ping-req salt (engine._uniform's "
        "arithmetic): the column counter j mixed as base + j * 0x01000193 and "
        "onward into uint32 bits, not an index"
    ),
}


# ---------------------------------------------------------------------------
# interval arithmetic (None endpoint = ±∞, None interval = top); JAX's


def iv_neg(a: Optional[Interval]) -> Optional[Interval]:
    if a is None:
        return None
    return Interval(None if a.hi is None else -a.hi, None if a.lo is None else -a.lo)


def iv_add(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    if a is None or b is None:
        return None
    lo = None if (a.lo is None or b.lo is None) else a.lo + b.lo
    hi = None if (a.hi is None or b.hi is None) else a.hi + b.hi
    return Interval(lo, hi)


def iv_sub(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    return iv_add(a, iv_neg(b))


def iv_mul(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    if a is None or b is None:
        return None
    if None not in (a.lo, a.hi, b.lo, b.hi):
        c = (a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi)
        return Interval(min(c), max(c))
    if a.lo is not None and b.lo is not None and a.lo >= 0 and b.lo >= 0:
        hi = None if (a.hi is None or b.hi is None) else a.hi * b.hi
        return Interval(a.lo * b.lo, hi)
    return FULL


def iv_scale(a: Optional[Interval], k: int) -> Optional[Interval]:
    return iv_mul(a, point(k))


def iv_min(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    if a is None or b is None:
        return None
    return Interval(_min(a.lo, b.lo), _min(a.hi, b.hi))


def iv_max(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    if a is None or b is None:
        return None
    return Interval(_max(a.lo, b.lo), _max(a.hi, b.hi))


def iv_abs(a: Optional[Interval]) -> Optional[Interval]:
    if a is None:
        return None
    if a.lo is not None and a.lo >= 0:
        return a
    if a.hi is not None and a.hi <= 0:
        return iv_neg(a)
    hi = None
    if a.lo is not None and a.hi is not None:
        hi = max(-a.lo, a.hi)
    return Interval(0, hi)


def iv_div(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    """Truncating integer division, only for a finite divisor without 0."""
    if a is None or b is None or None in (a.lo, a.hi, b.lo, b.hi):
        return None
    if b.lo <= 0 <= b.hi:
        return None
    c = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            c.append(int(x / y) if (x < 0) != (y < 0) else x // y)
    return Interval(min(c), max(c))


def iv_rem(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    """C-style remainder (the dividend's sign): ``torch.fmod``."""
    if b is None or b.lo is None or b.hi is None:
        return None
    m = max(abs(b.lo), abs(b.hi))
    if m == 0:
        return None
    lo = 0
    if a is None or a.lo is None or a.lo < 0:
        lo = -(m - 1)
    hi = m - 1
    if a is not None and a.lo is not None and a.hi is not None:
        if 0 <= a.hi < m and a.lo >= 0:
            return a
    return Interval(lo, hi)


def _bit_ceiling(v: int) -> int:
    """Smallest 2^k - 1 >= v (for or/xor upper bounds)."""
    return (1 << max(v, 0).bit_length()) - 1


def iv_and(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    if a is None or b is None:
        return None
    if a.lo is not None and b.lo is not None and a.lo >= 0 and b.lo >= 0:
        return Interval(0, _min(a.hi, b.hi))
    return None


def iv_orxor(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    if a is None or b is None:
        return None
    if (a.lo is not None and b.lo is not None and a.lo >= 0 and b.lo >= 0
            and a.hi is not None and b.hi is not None):
        return Interval(0, _bit_ceiling(max(a.hi, b.hi)))
    return None


def iv_shl(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    if (a is None or b is None or None in (a.lo, a.hi, b.lo, b.hi)
            or a.lo < 0 or b.lo < 0 or b.hi > 64):
        return None
    return Interval(a.lo << b.lo, a.hi << b.hi)


def iv_shr(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    """Logical right shift (JAX's ``shift_right_logical``)."""
    if a is None or b is None or a.lo is None or a.lo < 0:
        return None
    if b is None or b.lo is None or b.lo < 0:
        return Interval(0, a.hi)
    hi = None if a.hi is None else a.hi >> b.lo
    lo = 0
    if a.lo is not None and b.hi is not None:
        lo = a.lo >> b.hi
    return Interval(lo, hi)


# -- the port's own (torch's semantics where they differ from lax's) --------


def iv_ashr(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    """Arithmetic right shift (torch's ``>>`` on a signed dtype)."""
    if a is None or b is None or None in (a.lo, a.hi, b.lo, b.hi) or b.lo < 0:
        return None
    c = [x >> y for x in (a.lo, a.hi) for y in (b.lo, min(b.hi, 64))]
    return Interval(min(c), max(c))


def iv_floordiv(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    """Floor division (``floor_divide``, ``div(rounding_mode="floor")``)."""
    if a is None or b is None or None in (a.lo, a.hi, b.lo, b.hi):
        return None
    if b.lo <= 0 <= b.hi:
        return None
    c = [x // y for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return Interval(min(c), max(c))


def iv_remainder(a: Optional[Interval], b: Optional[Interval]) -> Optional[Interval]:
    """Python-style remainder (the divisor's sign): ``torch.remainder``."""
    if b is None or b.lo is None or b.hi is None:
        return None
    if b.lo > 0:
        if a is not None and a.lo is not None and a.hi is not None and 0 <= a.lo \
                and a.hi < b.lo:
            return a
        return Interval(0, b.hi - 1)
    if b.hi < 0:
        return Interval(b.lo + 1, 0)
    return None


def iv_not(a: Optional[Interval]) -> Optional[Interval]:
    """Bitwise not of a signed value: ``~x = -x - 1``."""
    return iv_sub(iv_neg(a), point(1))


# ---------------------------------------------------------------------------
# events


@dataclasses.dataclass(frozen=True)
class RangeEvent:
    """One certifier hit.  ``key`` is what the overflow prong's allowlist
    matches (``op@module.py:function``, or a state field's path for a
    carry), never an interval endpoint."""

    rule: str  # dtype-overflow | unbounded-carry | index-overflow
    key: str
    detail: str


class _Bottom:
    """The value of a fresh ``torch.empty``: nothing written yet."""

    def __repr__(self) -> str:
        return "<empty>"


BOTTOM = _Bottom()

# ops whose every result takes the first operand's range (views, copies,
# selections, reorderings)
_SOURCE_OPS = frozenset({
    "alias", "as_strided", "chunk", "clone", "contiguous", "detach", "diagonal", "expand",
    "expand_as", "flatten", "flip", "gather", "index", "index_select", "lift_fresh",
    "lift_fresh_copy", "masked_select", "movedim", "narrow", "permute", "repeat",
    "repeat_interleave", "reshape", "_reshape_alias", "roll", "select", "slice", "split",
    "split_with_sizes", "squeeze", "t", "take", "take_along_dim", "tile", "transpose",
    "unbind", "unfold", "unsqueeze", "_unsafe_view", "view_as", "amax", "amin", "cummax",
    "cummin", "max", "min", "sort", "topk", "msort", "unique_consecutive",
})
_BOOL_OPS = frozenset({
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
    "logical_xor", "isin", "isnan", "isinf", "isfinite", "any", "all", "signbit",
})
_EMPTY_OPS = frozenset({"empty", "empty_like", "new_empty", "empty_strided"})
# index ops whose operand 2 indexes operand 0 along the dim in operand 1
_INDEXED_BY_DIM = frozenset({
    "gather", "index_select", "scatter", "scatter_add", "scatter_reduce", "index_add",
    "index_copy", "index_fill",
})
# ops that make an index value (its extent the scaled size indexed)
_INDEX_VALUED = frozenset({"argsort", "argmax", "argmin", "searchsorted", "nonzero"})
# ops whose result carries its operands' index extent: from the first
# operand alone, the largest of all, or their sum
_TAG_FIRST = frozenset({"clone", "_to_copy", "contiguous", "index", "gather", "take",
                        "index_select", "lift_fresh", "expand", "repeat", "_unsafe_view",
                        "reshape", "clamp"})
_TAG_MAX = frozenset({"cat", "stack", "minimum", "maximum"})
_TAG_SUM = frozenset({"add", "sub"})


def _core(name: str) -> Tuple[str, str, bool]:
    """``aten::add_.Tensor`` -> ("add", "Tensor", in place)."""
    base = name.split("::", 1)[-1]
    op, _, overload = base.partition(".")
    if op.startswith("__") and op.endswith("__"):
        core = op[2:-2]
        inplace = core[:1] == "i" and core[1:] in ("and", "or", "xor", "lshift", "rshift")
        core = core[1:] if inplace else core
        op = {"and": "bitwise_and", "or": "bitwise_or", "xor": "bitwise_xor",
              "lshift": "bitwise_left_shift", "rshift": "bitwise_right_shift"}.get(core, core)
        return op, overload, inplace
    if op.endswith("_") and not op.endswith("__") and len(op) > 1:
        return op[:-1], overload, True
    return op, overload, False


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _arg(op: dataflow.OpRecord, i: int, name: str = "", default=None):
    if i < len(op.args):
        return op.args[i]
    for k, v in op.kwargs:
        if k == name:
            return v
    return default


class RangeInterpreter:
    """The interval interpreter over one recording (module docstring).

    ``run(seeds)`` interprets every op once from the input leaves' seeded
    intervals and returns each output leaf's interval.  Events accumulate
    across runs (the carry fixpoint reruns it), keyed so a rerun
    overwrites; ``wrap_hits`` collects the :data:`WRAP_CONTRACT` rows that
    silenced an escape."""

    def __init__(self, recording: dataflow.Recording, spec: Optional[ScaleSpec] = None,
                 wrap: Optional[Dict[str, str]] = None):
        if not recording.detail:
            raise ValueError("the range interpreter needs a recording made with detail=True")
        self.rec = recording
        self.spec = spec or ScaleSpec()
        self.wrap = WRAP_CONTRACT if wrap is None else wrap
        self._events: Dict[Tuple[str, str], RangeEvent] = {}
        self.wrap_hits: set = set()
        self._wrap_cache: Dict[str, Optional[str]] = {}

    def events(self) -> List[RangeEvent]:
        return list(self._events.values())

    def _emit(self, rule: str, key: str, detail: str) -> None:
        self._events.setdefault((rule, key), RangeEvent(rule, key, detail))

    def _wrap_row(self, loc: str) -> Optional[str]:
        if loc not in self._wrap_cache:
            self._wrap_cache[loc] = next(
                (pat for pat in self.wrap if fnmatch.fnmatchcase(loc, pat)), None)
        return self._wrap_cache[loc]

    # -- the walk -------------------------------------------------------------

    def run(self, seeds: Sequence[Optional[Interval]]) -> List[Optional[Interval]]:
        rec = self.rec
        env: Dict[int, object] = {}
        tags: Dict[int, int] = {}  # value id -> its at-scale index extent
        for vid, iv in zip(rec.input_values, seeds):
            if vid is not None:
                env[vid] = iv if vid not in env else union(env[vid], iv)
        self.env, self.tags = env, tags
        for op in rec.ops:
            self._step(op)
        return [self._value(v, meta[1] if meta else None)
                for v, meta in zip(rec.output_values, rec.output_meta)]

    def _value(self, vid, dtype) -> Optional[Interval]:
        """A value's interval as an operand."""
        if vid is None:
            return None
        if vid in self.env:
            got = self.env[vid]
            if got is BOTTOM:
                return dtype_interval(dtype) if dtype is not None else None
            return got
        c = self.rec.concrete.get(vid)
        if c is not None:
            return Interval(c[0], c[1])
        return dtype_interval(dtype) if dtype is not None else None

    def _operand(self, op, a):
        """An argument's interval: a tensor's value, a Python int's point."""
        if isinstance(a, dataflow.TensorArg):
            if 0 <= a.index < len(op.inputs):
                return self._value(op.inputs[a.index], op.in_dtypes[a.index])
            return None
        if isinstance(a, bool):
            return point(int(a))
        if isinstance(a, int):
            return point(a)
        if isinstance(a, float) and a.is_integer() and abs(a) < 2**63:
            return point(int(a))
        return None

    def _tensor_operands(self, op) -> List[Optional[Interval]]:
        return [self._value(v, d) for v, d in zip(op.inputs, op.in_dtypes)]

    def _step(self, op: dataflow.OpRecord) -> None:
        core, overload, inplace = _core(op.name)
        try:
            raw = self._transfer(core, overload, op)
        except (IndexError, TypeError, ValueError, ZeroDivisionError):
            raw = None
        n_out = len(op.out_dtypes)
        if raw is None:
            raw = [None] * n_out
        elif len(raw) < n_out:
            raw = list(raw) + [None] * (n_out - len(raw))
        in_set = set(op.inputs)
        new_of = {new: old for old, new in op.writes}
        in_vals = None
        for i, vid in enumerate(op.outputs):
            if vid is None:
                continue
            if i >= n_out:
                self.env[vid] = None  # an argument written, not a result
                continue
            if vid in in_set:
                continue  # a view: the storage's value as it was
            if in_vals is None:
                in_vals = self._tensor_operands(op)
            val = raw[i]
            if val is BOTTOM:
                self.env[vid] = BOTTOM
                continue
            val = self._finalize(core, op, i, in_vals, val)
            old = new_of.get(vid)
            if old is not None:
                prev = self.env.get(old, self._value(old, op.out_dtypes[i]))
                val = val if prev is BOTTOM else union(prev, val)
            self.env[vid] = val
        self._index_checks(core, op)
        self._tag(core, op)

    # -- one result -------------------------------------------------------------

    def _finalize(self, core, op, i, in_vals, raw) -> Optional[Interval]:
        dt = op.out_dtypes[i]
        if not _is_int_like(dt):
            return None
        rng = dtype_interval(dt)
        if raw is None:
            return rng
        if not (raw.lo is None or raw.hi is None or raw.lo < rng.lo or raw.hi > rng.hi):
            return raw
        if not _is_signed(dt):
            return rng  # unsigned: mod-2^n wrap is the contract
        row = self._wrap_row(op.loc)
        if row is not None:
            if self._inputs_tame(op, in_vals):
                self.wrap_hits.add(row)
            return rng
        if self._inputs_tame(op, in_vals):
            self._emit(
                "dtype-overflow", f"{core}@{op.loc or '<top>'}",
                f"'{core}' result range {raw} escapes {_dname(dt)} {rng} from in-range "
                "inputs")
        return raw  # kept unclamped so carry growth stays visible

    @staticmethod
    def _inputs_tame(op, in_vals) -> bool:
        """Every integer operand sits strictly inside its dtype: the escape
        is made here, not inherited (JAX's rule, edge values included)."""
        for dt, val in zip(op.in_dtypes, in_vals):
            if not _is_int_like(dt):
                continue
            if val is None:
                return False
            rng = dtype_interval(dt)
            if val.lo is None or val.hi is None or val.lo < rng.lo or val.hi > rng.hi:
                return False
            if _itemsize(dt) >= 4 and _dname(dt) != "bool" and (
                    val.lo == rng.lo or val.hi == rng.hi):
                return False
        return True

    # -- transfer functions -------------------------------------------------------

    def _transfer(self, core: str, overload: str, op: dataflow.OpRecord):
        a = lambda i, name="", default=None: self._operand(op, _arg(op, i, name, default))  # noqa: E731
        n_out = len(op.out_dtypes)
        if not op.inputs:
            if core in _EMPTY_OPS:
                return [BOTTOM]
            if core in ("randint", "random"):
                lo, hi = (0, _arg(op, 0)) if len(op.args) < 3 else (_arg(op, 0), _arg(op, 1))
                if isinstance(lo, int) and isinstance(hi, int):
                    return [Interval(lo, hi - 1)]
                return [None]
            c = self.rec.concrete.get(op.outputs[0]) if op.outputs else None
            if c is not None:
                return [Interval(c[0], c[1])]
            return [None]
        if core in _EMPTY_OPS:
            return [BOTTOM]
        if core in ("zeros_like", "new_zeros", "zero"):
            return [point(0)]
        if core in ("ones_like", "new_ones"):
            return [point(1)]
        if core in ("full_like", "new_full", "fill"):
            return [a(1)] if core != "new_full" else [a(2)]
        if core in _BOOL_OPS:
            return [BOOL] * n_out
        if core == "add":
            return [iv_add(a(0), iv_mul(a(1), a(2, "alpha", 1)))]
        if core == "sub":
            return [iv_sub(a(0), iv_mul(a(1), a(2, "alpha", 1)))]
        if core == "rsub":
            return [iv_sub(iv_mul(a(1), a(2, "alpha", 1)), a(0))]
        if core == "mul":
            return [iv_mul(a(0), a(1))]
        if core == "neg":
            return [iv_neg(a(0))]
        if core == "abs":
            return [iv_abs(a(0))]
        if core == "sign":
            return [Interval(-1, 1)]
        if core == "div":
            mode = _arg(op, 2, "rounding_mode")
            if mode == "floor":
                return [iv_floordiv(a(0), a(1))]
            if mode == "trunc":
                return [iv_div(a(0), a(1))]
            return [None]
        if core == "floor_divide":
            return [iv_floordiv(a(0), a(1))]
        if core == "remainder":
            return [iv_remainder(a(0), a(1))]
        if core == "fmod":
            return [iv_rem(a(0), a(1))]
        if core in ("maximum", "fmax") or (core == "max" and overload == "other"):
            return [iv_max(a(0), a(1))]
        if core in ("minimum", "fmin") or (core == "min" and overload == "other"):
            return [iv_min(a(0), a(1))]
        if core in ("clamp", "clip"):
            out = a(0)
            lo, hi = _arg(op, 1, "min"), _arg(op, 2, "max")
            if lo is not None:
                out = iv_max(out, self._operand(op, lo))
            if hi is not None:
                out = iv_min(out, self._operand(op, hi))
            return [out]
        if core == "clamp_min":
            return [iv_max(a(0), a(1))]
        if core == "clamp_max":
            return [iv_min(a(0), a(1))]
        if core == "where":
            return [union(a(1), a(2))]
        if core == "bitwise_and":
            if _dname(op.out_dtypes[0]) == "bool":
                return [BOOL]
            return [iv_and(a(0), a(1))]
        if core in ("bitwise_or", "bitwise_xor"):
            if _dname(op.out_dtypes[0]) == "bool":
                return [BOOL]
            return [iv_orxor(a(0), a(1))]
        if core == "bitwise_not":
            if _dname(op.out_dtypes[0]) == "bool":
                return [BOOL]
            return [iv_not(a(0))]
        if core == "bitwise_left_shift":
            return [iv_shl(a(0), a(1))]
        if core == "bitwise_right_shift":
            if _is_signed(op.in_dtypes[0]):
                return [iv_ashr(a(0), a(1))]
            return [iv_shr(a(0), a(1))]
        if core == "pow" and overload.startswith("Tensor_Scalar"):
            return [self._integer_pow(a(0), _arg(op, 1))]
        if core in ("sum", "cumsum"):
            return [self._sum(core, op, a(0))]
        if core in ("argmax", "argmin", "argsort", "nonzero"):
            size = self._reduced_size(op)
            return [Interval(0, max(size - 1, 0))] * n_out
        if core in ("sort", "topk", "max", "min", "kthvalue", "mode", "median") and n_out == 2:
            size = self._reduced_size(op)
            return [a(0), Interval(0, max(size - 1, 0))]
        if core == "searchsorted":
            seq = op.in_shapes[0]
            return [Interval(0, seq[-1] if seq else 0)]
        if core in ("cat", "stack", "hstack", "vstack"):
            out = BOTTOM
            for t in _arg(op, 0):
                v = self._operand(op, t)
                out = v if out is BOTTOM else union(out, v)
            return [None if out is BOTTOM else out]
        if core == "constant_pad_nd":
            return [union(a(0), a(2, "value", 0))]
        if core in ("scatter", "index_copy", "masked_scatter", "index_put", "index_fill",
                    "masked_fill", "copy", "scatter_reduce", "scatter_add", "index_add",
                    "_index_put_impl"):
            return [self._scatter(core, op, a)]
        if core in ("_to_copy", "to", "type_as", "_convert_element_type"):
            return [self._convert(op, a(0))]
        if core == "view" and overload == "dtype":
            return [None]
        if core in _SOURCE_OPS:
            return [a(0)] * n_out
        return None

    @staticmethod
    def _integer_pow(a: Optional[Interval], y) -> Optional[Interval]:
        if a is None or a.lo is None or a.hi is None or not isinstance(y, int) or y < 0:
            return None
        cands = [a.lo ** y, a.hi ** y]
        if a.lo <= 0 <= a.hi:
            cands.append(0)
        return Interval(min(cands), max(cands))

    def _dims(self, op, shape) -> List[int]:
        dim = _arg(op, 1, "dim")
        if dim is None or dim == ():
            return list(range(len(shape)))
        dims = dim if isinstance(dim, tuple) else (dim,)
        return [d % max(len(shape), 1) for d in dims if isinstance(d, int)]

    def _reduced_size(self, op) -> int:
        shape = op.in_shapes[0] if op.in_shapes else ()
        dims = self._dims(op, shape)
        return _numel(shape[d] for d in dims) if shape else 1

    def _sum(self, core, op, v) -> Optional[Interval]:
        shape = op.in_shapes[0]
        dims = self._dims(op, shape) if shape else []
        count = _numel(shape[d] for d in dims)
        scaled = _numel(scaled_dim(shape[d], self.spec) for d in dims)
        if core == "cumsum":
            out = iv_mul(v, Interval(min(1, count), max(count, 1)))
        else:
            out = iv_scale(v, max(count, 1))
        dt = op.out_dtypes[0]
        if (scaled != count and _is_signed(dt) and v is not None
                and self._inputs_tame(op, [v])
                and self._wrap_row(op.loc) is None):
            at_scale = iv_scale(v, max(scaled, 1))
            rng = dtype_interval(dt)
            if (at_scale is not None and at_scale.lo is not None and at_scale.hi is not None
                    and (at_scale.lo < rng.lo or at_scale.hi > rng.hi)):
                self._emit(
                    "dtype-overflow", f"{core}.scaled@{op.loc or '<top>'}",
                    f"'{core}' over a scaled axis ({count} -> {scaled} at {self.spec.label()}) "
                    f"accumulates {at_scale}, escaping {_dname(dt)} {rng} — fine at the "
                    f"n={self.spec.toy_n} recording, wraps at the declared ceiling")
        return out

    def _convert(self, op, val) -> Optional[Interval]:
        src, dst = op.in_dtypes[0], op.out_dtypes[0]
        if _dname(dst) == "bool":
            return BOOL
        if not _is_int_like(src):
            return None  # float -> int: the dtype's range
        sb, db = _INT_BITS.get(_dname(src)), _INT_BITS.get(_dname(dst))
        if sb and db and sb[0] == db[0] and sb[1] != db[1]:
            # same-width signed <-> unsigned: the sanctioned bit cast
            rng = dtype_interval(dst)
            if val is None or val.lo is None or val.hi is None or val.lo < rng.lo \
                    or val.hi > rng.hi:
                return rng
        return val

    def _scatter(self, core, op, a) -> Optional[Interval]:
        if core in ("index_put", "_index_put_impl"):
            values = a(2)
            if _arg(op, 3, "accumulate", False):
                return self._additive(a(0), values, op.in_shapes[-1] if op.in_shapes else ())
            return union(a(0), values)
        if core == "copy":
            return a(1)
        if core in ("masked_fill", "index_fill"):
            return union(a(0), a(2) if core == "masked_fill" else a(3))
        if core == "masked_scatter":
            return union(a(0), a(2))
        if core in ("scatter_add", "index_add"):
            src = _arg(op, 3)
            shape = op.in_shapes[src.index] if isinstance(src, dataflow.TensorArg) else ()
            return self._additive(a(0), a(3), shape)
        if core == "scatter_reduce":
            reduce = _arg(op, 4, "reduce")
            if reduce == "sum":
                src = _arg(op, 3)
                shape = op.in_shapes[src.index] if isinstance(src, dataflow.TensorArg) else ()
                return self._additive(a(0), a(3), shape)
            if reduce in ("amax", "amin"):
                return union(a(0), a(3))
            return None
        # scatter (src or value), index_copy: the source's range joins
        return union(a(0), a(3))

    @staticmethod
    def _additive(operand, updates, upd_shape) -> Optional[Interval]:
        bump = iv_scale(updates, max(_numel(upd_shape), 1))
        if bump is None:
            return None
        lo = operand.lo if operand is not None else None
        hi = operand.hi if operand is not None else None
        if lo is not None:
            lo = lo + min(bump.lo, 0) if bump.lo is not None else None
        if hi is not None:
            hi = hi + max(bump.hi, 0) if bump.hi is not None else None
        return Interval(lo, hi)

    # -- index-space safety at the declared ceiling ------------------------------

    def _index_checks(self, core: str, op: dataflow.OpRecord) -> None:
        spec = self.spec
        checks: List[Tuple[str, int, str]] = []  # (index dtype, extent, tag)
        if core == "arange" and op.out_shapes and op.out_shapes[0]:
            checks.append((op.out_dtypes[0], scaled_dim(op.out_shapes[0][0], spec), "arange"))
        elif core in _INDEXED_BY_DIM and len(op.inputs) >= 2:
            dim = _arg(op, 1, "dim")
            idx = _arg(op, 2, "index")
            shape = op.in_shapes[0]
            if isinstance(dim, int) and isinstance(idx, dataflow.TensorArg) and shape:
                checks.append((op.in_dtypes[idx.index],
                               scaled_dim(shape[dim % len(shape)], spec), f"{core}.dim"))
        elif core in ("index", "index_put", "_index_put_impl"):
            shape = op.in_shapes[0] if op.in_shapes else ()
            for k, t in enumerate(_arg(op, 1) or ()):
                if isinstance(t, dataflow.TensorArg) and k < len(shape):
                    checks.append((op.in_dtypes[t.index], scaled_dim(shape[k], spec),
                                   f"{core}.dim{k}"))
        elif core == "take" and len(op.inputs) >= 2:
            checks.append((op.in_dtypes[1], self._scaled_numel(op.in_shapes[0]), "take"))
        for dt, extent, tag in checks:
            rng = dtype_interval(dt)
            if rng is None or rng.hi is None or _dname(dt) == "bool":
                continue
            if extent - 1 > rng.hi:
                self._emit(
                    "index-overflow", f"{tag}@{op.loc or '<top>'}",
                    f"'{core}' index lane is {_dname(dt)} but the indexed extent reaches "
                    f"{extent} at the declared ceiling ({spec.label()})")

    def _scaled_numel(self, shape) -> int:
        return _numel(scaled_dim(d, self.spec) for d in shape)

    def _tag(self, core: str, op: dataflow.OpRecord) -> None:
        """Follow index values at scale: a value made as an index into a
        scaled extent (``argsort``, ``searchsorted``, ``arange``, ...) carries
        that extent; arithmetic on two such values multiplies or adds them;
        an integer result narrower than its carried extent is an
        ``index-overflow`` (an int32 flat offset ``row * n + col``, a
        ``.to(torch.int32)`` of an int64 ``searchsorted``)."""
        tags = self.tags
        out_tag = None
        if core in _INDEX_VALUED or (core in ("sort", "topk") and len(op.outputs) > 1):
            shape = op.in_shapes[-1 if core == "searchsorted" else 0] if op.in_shapes else ()
            if shape:
                dims = [len(shape) - 1] if core in ("searchsorted", "sort", "topk",
                                                    "argsort") else self._dims(op, shape)
                out_tag = self._scaled_numel([shape[d] for d in dims]) + (
                    1 if core == "searchsorted" else 0)
            if core in ("sort", "topk"):
                vid = op.outputs[1] if len(op.outputs) > 1 else None
                if vid is not None and out_tag is not None:
                    tags[vid] = out_tag
                return
        elif core == "arange" and op.out_shapes and op.out_shapes[0]:
            out_tag = scaled_dim(op.out_shapes[0][0], self.spec)
        else:
            in_tags = [tags.get(v) for v in op.inputs]
            if core == "where":  # the values come from the two arms
                in_tags = [tags.get(op.inputs[x.index]) for x in op.args[1:3]
                           if isinstance(x, dataflow.TensorArg)]
            elif core in _TAG_FIRST:
                in_tags = in_tags[:1]
            known = [t for t in in_tags if t is not None]
            if not known:
                return
            if core == "mul":
                if len(known) == 2:
                    out_tag = known[0] * known[1]
                else:  # times a scalar, or a tensor without an extent
                    k = next((x for x in op.args if isinstance(x, int)
                              and not isinstance(x, bool)), None)
                    if k is None:
                        other = [self._value(v, d) for v, d in zip(op.inputs, op.in_dtypes)
                                 if tags.get(v) is None]
                        k = other[0].hi if other and other[0] is not None else None
                    if k is None or k <= 0:
                        return
                    out_tag = known[0] * scaled_dim(k, self.spec)
            elif core in ("remainder", "fmod"):
                d = _arg(op, 1)
                out_tag = known[0]
                if isinstance(d, int) and d > 0:
                    out_tag = min(out_tag, scaled_dim(d, self.spec))
            elif core in _TAG_SUM:
                out_tag = sum(known)
            elif core in _TAG_FIRST or core in _TAG_MAX or core == "where":
                out_tag = max(known)
            else:
                return
            row = self._wrap_row(op.loc)
            if row is not None and any(_is_int_like(d) and _itemsize(d) >= 2
                                       and out_tag - 1 > dtype_interval(d).hi
                                       for d in op.out_dtypes):
                # an index past its lane there is mixed into bits by
                # contract, not an index: no tag leaves the op
                self.wrap_hits.add(row)
                return
        if out_tag is None:
            return
        in_tags = {v: tags.get(v) for v in op.inputs}
        for i, vid in enumerate(op.outputs[:len(op.out_dtypes)]):
            dt = op.out_dtypes[i]
            if vid is None or vid in in_tags or _itemsize(dt) < 2 or not _is_int_like(dt):
                continue
            tags[vid] = out_tag
            rng = dtype_interval(dt)
            if rng is None or _dname(dt) == "bool" or out_tag - 1 <= rng.hi:
                continue
            # report where the narrow lane is made, not downstream of it
            inherited = any(
                t is not None and t - 1 > dtype_interval(d).hi
                for t, d in zip((tags.get(v) for v in op.inputs), op.in_dtypes)
                if dtype_interval(d) is not None)
            if not inherited and core != "arange":
                self._emit(
                    "index-overflow", f"{core}.scaled@{op.loc or '<top>'}",
                    f"'{core}' gives a {_dname(dt)} index value whose extent reaches "
                    f"{out_tag} at the declared ceiling ({self.spec.label()})")


# ---------------------------------------------------------------------------
# the entry-level analysis: contracts, the carry fixpoint


def leaf_names(recording: dataflow.Recording, args) -> Tuple[List[str], List[str]]:
    """Each input and output leaf's field path (``SimState.tick_index``;
    ``args[1]`` or ``out[0]`` outside a registered state class)."""
    from ringpop_tpu_torch.analysis import noninterference as ni

    regs = ni.state_registries()
    ins = [lab.path for lab in dataflow.flatten(ni.label_tree(tuple(args), regs, "args"))]
    outs = [lab.path for lab in dataflow.flatten(ni.label_tree(recording.out, regs, "out"))]
    return ins, outs


def _is_u32_path(path: str, u32: Dict[str, frozenset]) -> bool:
    cls, _, field = path.partition(".")
    return field in u32.get(cls, ())


def contract_seeds(recording: dataflow.Recording, names: Sequence[str]) -> List[Optional[Interval]]:
    u32 = uint32_fields()
    out = []
    for meta, name in zip(recording.input_meta, names):
        out.append(None if meta is None else input_contract(meta[1], _is_u32_path(name, u32)))
    return out


def _escapes(iv: Optional[Interval], dt) -> bool:
    rng = dtype_interval(dt)
    if rng is None:
        return False
    return iv is None or iv.lo is None or iv.hi is None or iv.lo < rng.lo or iv.hi > rng.hi


def analyze(recording: dataflow.Recording, spec: Optional[ScaleSpec] = None,
            in_names: Optional[Sequence[str]] = None,
            out_names: Optional[Sequence[str]] = None,
            wrap: Optional[Dict[str, str]] = None,
            max_rounds: int = 16) -> Tuple[List[RangeEvent], set]:
    """Run the certifier over one recording: returns (events, the
    :data:`WRAP_CONTRACT` rows that silenced an escape).

    With ``in_names``/``out_names`` (state-field paths, :func:`leaf_names`)
    the signed state leaves are a carry: each output leaf's interval is
    widened back into the input leaves of the same path until stable, and
    a field whose fixpoint escapes its dtype is an ``unbounded-carry``."""
    interp = RangeInterpreter(recording, spec, wrap)
    names = list(in_names) if in_names is not None else [""] * len(recording.input_values)
    seeds = contract_seeds(recording, names)
    carry: Dict[str, List[int]] = {}
    if out_names is not None:
        u32 = uint32_fields()
        outs_by_name: Dict[str, List[int]] = {}
        for j, nm in enumerate(out_names):
            outs_by_name.setdefault(nm, []).append(j)
        for i, (nm, meta) in enumerate(zip(names, recording.input_meta)):
            if (meta is not None and "." in nm and not nm.startswith(("args", "out"))
                    and _is_signed(meta[1]) and not _is_u32_path(nm, u32)
                    and nm in outs_by_name):
                carry.setdefault(nm, []).append(i)
    for _ in range(max_rounds):
        outs = interp.run(seeds)
        changed = False
        for nm, ins in carry.items():
            fed = None
            first = True
            for j in [j for j, o in enumerate(out_names) if o == nm]:
                fed = outs[j] if first else union(fed, outs[j])
                first = False
            for i in ins:
                new = widen(seeds[i], fed) if seeds[i] is not None else None
                if new != seeds[i]:
                    seeds[i] = new
                    changed = True
        if not changed:
            break
    for nm, ins in sorted(carry.items()):
        i = ins[0]
        dt = recording.input_meta[i][1]
        if _escapes(seeds[i], dt):
            interp._emit(
                "unbounded-carry", nm,
                f"{_dname(dt)} state field '{nm}' widens to {seeds[i]} across ticks — a "
                f"per-tick-growing value wraps {_dname(dt)} past the {TICK_CEILING}-tick "
                "serving envelope")
    return interp.events(), interp.wrap_hits


# ---------------------------------------------------------------------------
# the footprint polynomial


def _price(shape, dtype, spec: ScaleSpec, poly: Dict[int, int]) -> None:
    coeff = _itemsize(dtype)
    exp = 0
    for d in shape:
        kind, v = _dim_rule(d, spec)
        if kind == "scaled":
            exp += 1
        coeff *= v
    poly[exp] = poly.get(exp, 0) + coeff


def buffer_poly(recording: dataflow.Recording, spec: ScaleSpec) -> Dict[int, int]:
    """The entry's footprint as a polynomial in N, ``{exponent: bytes}``:
    the at-scale bytes of every input leaf and of every new storage an op
    made (views and in-place writes allocate nothing), the exponent
    counting scaled dims.  No liveness: an upper bound on the live peak,
    the right side for a feasibility ceiling (JAX's ``buffer_poly``)."""
    if not recording.detail:
        raise ValueError("buffer_poly needs a recording made with detail=True")
    poly: Dict[int, int] = {}
    seen = set()
    for vid, meta in zip(recording.input_values, recording.input_meta):
        if vid is None or meta is None or vid in seen:
            continue
        seen.add(vid)
        _price(meta[0], meta[1], spec, poly)
    for op in recording.ops:
        for shape, dt, alloc in zip(op.out_shapes, op.out_dtypes, op.out_alloc):
            if alloc:
                _price(shape, dt, spec, poly)
    return {e: int(math.ceil(c)) for e, c in sorted(poly.items())}


def poly_bytes(poly: Dict[int, int], n: int) -> int:
    return sum(c * n ** e for e, c in poly.items())


def feasible_n(poly: Dict[int, int], budget_bytes: int, n_max: int) -> int:
    """Largest N <= n_max with poly(N) <= budget (binary search; 0 when
    even N = 1 busts the budget)."""
    if poly_bytes(poly, 1) > budget_bytes:
        return 0
    lo, hi = 1, n_max
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if poly_bytes(poly, mid) <= budget_bytes:
            lo = mid
        else:
            hi = mid - 1
    return lo
