"""The op recorder and the dataflow slicer under the graph and
noninterference prongs.

Counterpart of ``ringpop_tpu/analysis/dataflow.py``.  JAX's prongs walk a
``ClosedJaxpr``; the port has no graph to walk, and ``torch.fx``'s
``make_fx`` cannot stand in for ``jax.make_jaxpr``: a gated tick reads
predicates on the host (``run_solo`` answers each ``pred`` and ``counts``
its body yields), and tracing fails on the first such read
("``aten._local_scalar_dense``" on a tracing tensor).  :class:`Recorder`, a
``TorchDispatchMode``, instead runs the entry on real tensors and logs each
aten op as it executes: its input and output values, their dtypes, and
every host read (``_local_scalar_dense``, ``item``, ``nonzero``,
``equal`` and copies from a card to the CPU) and every upload of a host
table (``lift_fresh`` of a tensor of one dimension or more: on the card a
synchronous copy).  It sees the host reads
instead of failing on them, and it covers the gated tick, the storm,
``run_solo``'s generators and ``torch.func.vmap`` (whose batching rules
reach the mode as ops on the unbatched tensors).

Values are versions of storages.  A view shares its base's storage, so it
reads and carries its base's labels; an in-place op or an ``out=`` write
(an argument the op's schema marks as written) makes a new version of
that storage, whose labels join the old version's and the op's inputs'.
A recording keeps every tensor it saw alive until it is dropped, so no
storage address is reused within one.

With ``detail`` on (the ranges, cost and aliasing prongs), each
:class:`OpRecord` also keeps its operands' and results' shapes, its
non-tensor arguments (:data:`OpRecord.args`, a tensor standing as its
:class:`TensorArg` position among ``inputs``), which results are new
storages (``out_alloc``) and the storages it wrote (``writes``); and the
recording keeps each value's first version (``roots``: an in-place write
makes a new version of the same storage), and the concrete
``(min, max)`` of every integer value made from no tensor input
(``arange``, ``full``, ``zeros``, ``scalar_tensor``, ``randint``, ...) and of
every tensor the entry reads that was made outside it (a constant table,
a lifted scalar).  ``graph`` and ``noninterference`` record without it.

:func:`slice_reachability` propagates labels from chosen input leaves to
every output leaf with witness chains (:class:`Witness`,
:func:`witness_chain`), as JAX's does over a jaxpr.  A host read whose
input carries a label taints every op after it: the value steered Python
control flow, which steers what follows — the control dependence JAX's
``precise=True`` walk models for ``cond`` predicates and ``while``
conditions.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "HASH_CONSTANTS",
    "TensorArg",
    "HOST_READ_OPS",
    "OpRecord",
    "Recording",
    "Recorder",
    "record",
    "flatten",
    "Witness",
    "witness_chain",
    "slice_reachability",
]

# The farmhashmk mixing constants (c1, c2 and the round's additive): the
# hash-path taint seeds.  JAX's set also holds murmur3's finaliser
# constants 0x85EBCA6B and 0xC2B2AE35; they are left out here because both
# engines' counter-based rng folds its key with 0x85EBCA6B (``_fold``), so
# they would put every random draw on the hash path, and a farmhash value
# reaches the finaliser only after c1 and c2 have tainted it.
HASH_CONSTANTS = frozenset({0xCC9E2D51, 0x1B873593, 0xE6546B64})

# ops that read a device value on the host (the first,
# ``aten::_local_scalar_dense``, once per gated phase:
# ``engine_scalable.host_read.count`` counts the same reads)
HOST_READ_OPS = frozenset({
    "aten::_local_scalar_dense",
    "aten::item",
    "aten::nonzero",
    "aten::equal",
    "aten::is_nonzero",
})
LOCAL_SCALAR_DENSE = "aten::_local_scalar_dense"
# host data made a tensor (``torch.tensor``, ``as_tensor``, ``from_numpy``)
HOST_UPLOAD_OP = "aten::lift_fresh"

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_DIR = os.path.join(_PKG_DIR, "analysis")


@dataclasses.dataclass(frozen=True)
class TensorArg:
    """A tensor operand inside :attr:`OpRecord.args`: its position in the
    op's ``inputs``."""

    index: int


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op as it ran: ``inputs``/``outputs`` are value ids (a
    storage version each; None for a tensor with no storage or no data),
    ``loc`` the innermost port function on the stack (``module.py:func``),
    ``host_read`` whether the op synchronised with the host (a read, or an
    upload of a host table), and ``stack`` the port frames of an op that
    widened a hash-path value (:class:`Recorder` with ``hash_taint``).
    The rest is kept with ``detail`` only (module docstring); ``writes``
    pairs each written storage's value id before the op with the one
    after."""

    name: str
    inputs: Tuple[Optional[int], ...]
    outputs: Tuple[Optional[int], ...]
    in_dtypes: Tuple[str, ...]
    out_dtypes: Tuple[str, ...]
    loc: str = ""
    host_read: bool = False
    stack: Tuple[str, ...] = ()
    in_shapes: Tuple[Tuple[int, ...], ...] = ()
    out_shapes: Tuple[Tuple[int, ...], ...] = ()
    args: Tuple = ()
    kwargs: Tuple[Tuple[str, object], ...] = ()
    out_alloc: Tuple[bool, ...] = ()
    writes: Tuple[Tuple[int, int], ...] = ()


@dataclasses.dataclass
class Recording:
    """What one run of an entry recorded.  ``input_values[i]`` is the value
    id of flattened input leaf ``i`` (None: not a tensor), likewise
    ``output_values`` for the output leaves; ``hash_findings`` lists the ops
    that widened a hash-path value (with their port stacks)."""

    ops: List[OpRecord]
    input_values: List[Optional[int]]
    output_values: List[Optional[int]]
    out: object = None
    hash_findings: List[OpRecord] = dataclasses.field(default_factory=list)
    # with ``detail``: value id -> (min, max) of the integer values made
    # from no tensor input or outside the entry; each input and output
    # leaf's (shape, dtype) (None: not a tensor); each output leaf's
    # storage by the value id it first had; every value id's first version
    concrete: Dict[int, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    roots: Dict[int, int] = dataclasses.field(default_factory=dict)
    input_meta: List[Optional[Tuple[Tuple[int, ...], str]]] = dataclasses.field(
        default_factory=list)
    output_meta: List[Optional[Tuple[Tuple[int, ...], str]]] = dataclasses.field(
        default_factory=list)
    output_roots: List[Optional[int]] = dataclasses.field(default_factory=list)
    detail: bool = False

    @property
    def host_reads(self) -> List[OpRecord]:
        return [op for op in self.ops if op.host_read]


def _port_stack(limit: int = 0, skip: int = 2) -> Tuple[str, ...]:
    """``module.py:func`` of the port frames on the stack, innermost
    first, outside this analysis package (``limit`` > 0: at most that
    many; ``skip`` frames of the caller's own are passed over)."""
    out = []
    f = sys._getframe(skip)
    while f is not None:
        rel = _port_rel(f.f_code.co_filename)
        if rel is not None:
            out.append("%s:%s" % (rel, f.f_code.co_name))
            if limit and len(out) >= limit:
                break
        f = f.f_back
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _port_rel(filename: str) -> Optional[str]:
    """A port module's path inside the package, else None."""
    if not filename.startswith(_PKG_DIR) or filename.startswith(_ANALYSIS_DIR):
        return None
    return os.path.relpath(filename, _PKG_DIR).replace(os.sep, "/")


def _tensors(args, kwargs) -> list:
    """The tensors among an op's arguments (directly or in a list)."""
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _outputs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


@functools.lru_cache(maxsize=None)
def _written_args(func) -> Tuple[Tuple[int, str], ...]:
    """(position, name) of the arguments ``func``'s schema marks written."""
    return tuple(
        (i, arg.name)
        for i, arg in enumerate(func._schema.arguments)
        if arg.alias_info is not None and arg.alias_info.is_write
    )


def _storage_key(t: torch.Tensor):
    """The identity of ``t``'s storage (its device and base address), or
    None where it has none."""
    try:
        if t.numel() == 0:
            return None
        return (t.device, t.data_ptr() - t.storage_offset() * t.element_size())
    except (RuntimeError, NotImplementedError):
        return None


# the dtypes a hash-path value keeps its taint in (int32 holds uint32 bits)
_HASH_DTYPES = (torch.int32, torch.uint32)


def _wide(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex or dtype in (torch.int64, torch.uint64)


class Recorder(TorchDispatchMode):
    """Logs every aten op an entry runs (see the module docstring).

    ``track=False`` counts ops and host reads only: no value ids, no stack
    walks and no kept tensors, so it costs next to nothing and runs at a
    main path's full size on the card.  ``hash_taint`` additionally
    follows the hash path forward as the ops run: an op whose scalar
    operand is a farmhash constant seeds it, an int32 (uint32) result of a
    hash-path operand stays on it, and a float or 64-bit result of one is
    a widening, logged in ``hash_findings`` with its port stack unless
    ``allowed(stack)`` says it is deliberate; either way the path ends there.
    Other results (bool masks, bytes) leave the path, as JAX's audit
    follows only uint32 and int32 hops.  ``detail`` keeps the shapes,
    arguments, writes and concrete ranges (module docstring).  ``uploads``
    counts the host-table uploads among the host reads."""

    def __init__(self, track: bool = True, hash_taint: bool = False,
                 allowed: Optional[Callable[[Tuple[str, ...]], bool]] = None,
                 detail: bool = False):
        super().__init__()
        self.track = track
        self.hash_taint = hash_taint and track
        self.detail = detail and track
        self.allowed = allowed
        self.ops: List[OpRecord] = []
        self.host_reads = 0
        self.scalar_reads = 0
        self.uploads = 0
        self.n_ops = 0
        self.hash_findings: List[OpRecord] = []
        self._cur: Dict[tuple, int] = {}
        self._next = 0
        self._keep: List[torch.Tensor] = []
        self._hashed: set = set()
        # detail: value id -> the value id its storage first had; concrete
        # ranges (see Recording.concrete)
        self._root: Dict[int, int] = {}
        self.concrete: Dict[int, Tuple[int, int]] = {}

    # -- value ids ----------------------------------------------------------

    def _fresh(self) -> int:
        self._next += 1
        return self._next

    def value_of(self, t: torch.Tensor) -> Optional[int]:
        """The current value id of ``t``'s storage (a new one, for a tensor
        made outside the recording)."""
        key = _storage_key(t)
        if key is None:
            return None
        vid = self._cur.get(key)
        if vid is None:
            vid = self._fresh()
            self._cur[key] = vid
            self._keep.append(t)
            if self.detail:
                self._root[vid] = vid
                self._note_concrete(vid, t)
        return vid

    def root_of(self, vid: Optional[int]) -> Optional[int]:
        """The value id ``vid``'s storage first had (``detail`` only)."""
        return None if vid is None else self._root.get(vid, vid)

    def _note_concrete(self, vid: int, t: torch.Tensor) -> None:
        """Keep the (min, max) of an integer or bool CPU tensor."""
        if t.device.type != "cpu" or t.dtype.is_floating_point or t.dtype.is_complex:
            return
        if t.numel() == 0:
            return
        try:
            v = t.detach()
            if v.dtype == torch.bool:
                v = v.to(torch.uint8)
            elif v.dtype in (torch.uint16, torch.uint32, torch.uint64):
                v = v.to(torch.int64) if v.dtype != torch.uint64 else v
            self.concrete[vid] = (int(v.min()), int(v.max()))
        except (RuntimeError, NotImplementedError, TypeError):
            pass

    # -- the mode -------------------------------------------------------------

    @staticmethod
    def _is_host_read(name: str, in_tensors, out_tensors) -> bool:
        if name in HOST_READ_OPS:
            return True
        if name == HOST_UPLOAD_OP:
            # host data entering the graph: a table (one dimension or more)
            # is a synchronous copy on the card; a lifted Python scalar
            # stays a CPU operand a CUDA kernel takes as it is
            return any(t.dim() > 0 for t in out_tensors)
        # a copy from a card into host memory
        return any(t.device.type != "cpu" for t in in_tensors) and any(
            t.device.type == "cpu" for t in out_tensors
        )

    def _seeds_hash(self, args, kwargs) -> bool:
        for a in list(args) + list(kwargs.values()):
            vals = a if isinstance(a, (list, tuple)) else (a,)
            for v in vals:
                if isinstance(v, bool):
                    continue
                if isinstance(v, int) and (v % (1 << 32)) in HASH_CONSTANTS:
                    return True
                if (
                    isinstance(v, torch.Tensor)
                    and v.dim() == 0
                    and v.device.type == "cpu"
                    and not v.dtype.is_floating_point
                    and v.dtype != torch.bool
                    and _storage_key(v) not in self._cur
                    and (int(v) % (1 << 32)) in HASH_CONSTANTS
                ):
                    return True
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.name()
        in_tensors = _tensors(args, kwargs)
        if self.track:
            in_vids = [self.value_of(t) for t in in_tensors]
        out = func(*args, **kwargs)
        out_tensors = _outputs(out)
        host_read = self._is_host_read(name, in_tensors, out_tensors)
        self.n_ops += 1
        if host_read:
            self.host_reads += 1
            if name == LOCAL_SCALAR_DENSE:
                self.scalar_reads += 1
            elif name == HOST_UPLOAD_OP:
                self.uploads += 1
        if not self.track:
            return out

        # which arguments the op writes (in-place and out= variants)
        written = set()
        for i, arg_name in _written_args(func):
            v = args[i] if i < len(args) else kwargs.get(arg_name)
            for t in _outputs(v):
                written.add(_storage_key(t))
        in_keys = {_storage_key(t) for t in in_tensors}
        writes = []  # detail: (old, new) value ids of each written storage
        out_vids = []
        out_alloc = []
        for t in out_tensors:
            key = _storage_key(t)
            if key is None:
                out_vids.append(None)
                out_alloc.append(False)
                continue
            if key in in_keys and key not in written:
                out_vids.append(self._cur.get(key))  # a view: the same value
                out_alloc.append(False)
                continue
            old = self._cur.get(key)
            vid = self._fresh()
            self._cur[key] = vid
            self._keep.append(t)
            out_vids.append(vid)
            out_alloc.append(key not in written)
            if self.detail:
                self._root[vid] = self._root.get(old, old) if key in written and old else vid
                if key in written and old:
                    writes.append((old, vid))
                if not in_tensors:
                    self._note_concrete(vid, t)
        # a written argument that is not among the outputs still changed
        for key in sorted(written - {_storage_key(t) for t in out_tensors}, key=repr):
            if key is not None:
                old = self._cur.get(key)
                self._cur[key] = vid = self._fresh()
                out_vids.append(vid)
                if self.detail:
                    self._root[vid] = self._root.get(old, old) if old else vid
                    if old:
                        writes.append((old, vid))
        stack = _port_stack(limit=1)
        extra = {}
        if self.detail:
            extra = dict(
                in_shapes=tuple(tuple(t.shape) for t in in_tensors),
                out_shapes=tuple(tuple(t.shape) for t in out_tensors),
                args=_arg_spec(args, in_tensors),
                kwargs=tuple((k, _arg_spec((v,), in_tensors)[0]) for k, v in kwargs.items()),
                out_alloc=tuple(out_alloc),
                writes=tuple(writes),
            )
        rec = OpRecord(
            name=name,
            inputs=tuple(in_vids),
            outputs=tuple(out_vids),
            in_dtypes=tuple(str(t.dtype) for t in in_tensors),
            out_dtypes=tuple(str(t.dtype) for t in out_tensors),
            loc=stack[0] if stack else "",
            host_read=host_read,
            **extra,
        )
        self.ops.append(rec)
        if self.hash_taint:
            self._follow_hash(rec, args, kwargs, out_tensors)
        return out

    def _follow_hash(self, rec: OpRecord, args, kwargs, out_tensors) -> None:
        tainted = any(v in self._hashed for v in rec.inputs if v is not None)
        if not tainted and not self._seeds_hash(args, kwargs):
            return
        if tainted and any(_wide(t.dtype) for t in out_tensors):
            # the value leaves the hash path here: deliberately (allowed),
            # or as a finding
            stack = _port_stack(skip=3)
            if self.allowed is None or not self.allowed(stack):
                self.hash_findings.append(dataclasses.replace(rec, stack=stack))
            return
        for t, vid in zip(out_tensors, rec.outputs):
            if vid is not None and t.dtype in _HASH_DTYPES:
                self._hashed.add(vid)


def flatten(x) -> list:
    """The leaves of a tree of NamedTuples, tuples, lists and dicts, in
    order (None and every other object is a leaf): the one order both the
    recorder and the noninterference labels use."""
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in flatten(v)]
    if isinstance(x, dict):
        return [leaf for k in x for leaf in flatten(x[k])]
    return [x]


def _arg_spec(args, in_tensors) -> tuple:
    """An op's arguments with each tensor as its :class:`TensorArg` and
    every other value as a plain int, float, bool, str or None."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            i = next((j for j, t in enumerate(in_tensors) if t is a), -1)
            out.append(TensorArg(i))
        elif isinstance(a, (list, tuple)):
            out.append(_arg_spec(a, in_tensors))
        elif a is None or isinstance(a, (bool, int, float, str)):
            out.append(a)
        else:
            out.append(str(a))
    return tuple(out)


def _meta(t) -> Optional[Tuple[Tuple[int, ...], str]]:
    return (tuple(t.shape), str(t.dtype)) if isinstance(t, torch.Tensor) else None


def record(fn: Callable, args: Tuple, track: bool = True, hash_taint: bool = False,
           allowed=None, detail: bool = False) -> Recording:
    """Run ``fn(*args)`` under a :class:`Recorder` and return what it saw
    (``detail``: the shapes, arguments, writes and concrete ranges too)."""
    rec = Recorder(track=track, hash_taint=hash_taint, allowed=allowed, detail=detail)
    in_leaves = flatten(tuple(args))
    in_vids = [rec.value_of(t) if isinstance(t, torch.Tensor) and track else None
               for t in in_leaves]
    if rec.detail:
        # the entry's inputs are contracts, not constants
        for v in in_vids:
            rec.concrete.pop(v, None)
    with rec:
        out = fn(*args)
    out_leaves = flatten(out)
    out_vids = [
        rec._cur.get(_storage_key(t)) if isinstance(t, torch.Tensor) and track else None
        for t in out_leaves
    ]
    recording = Recording(rec.ops, in_vids, out_vids, out, rec.hash_findings)
    if rec.detail:
        recording.detail = True
        recording.concrete = dict(rec.concrete)
        recording.input_meta = [_meta(t) for t in in_leaves]
        recording.output_meta = [_meta(t) for t in out_leaves]
        recording.output_roots = [rec.root_of(v) for v in out_vids]
        recording.roots = dict(rec._root)
    return recording


# ---------------------------------------------------------------------------
# the noninterference slicer: label-set reachability with witness chains


@dataclasses.dataclass(frozen=True)
class Witness:
    """One hop of an input -> output flow: the op that carried it.
    Witnesses form a linked list back toward the seed (``prev``); a join
    keeps the first witness per label, so chains stay stable."""

    prim: str
    loc: str  # the port function the op ran in ("module.py:func")
    prev: Optional["Witness"] = None


def witness_chain(w: Optional[Witness], limit: int = 8) -> str:
    """Render a witness as ``seed-side -> ... -> output-side`` text."""
    hops: List[str] = []
    while w is not None:
        hops.append(f"{w.prim}@{w.loc or '<top>'}")
        w = w.prev
    hops.reverse()
    if len(hops) > limit:
        head = limit // 2
        tail = limit - head
        omitted = len(hops) - limit
        hops = hops[:head] + [f"... ({omitted} ops) ..."] + hops[-tail:]
    return " -> ".join(hops) if hops else "<direct>"


def _join(a: Dict[str, Witness], b: Dict[str, Witness]) -> Dict[str, Witness]:
    if not b:
        return a
    if not a:
        return b
    merged = dict(a)
    for k, v in b.items():
        merged.setdefault(k, v)
    return merged


def _short(name: str) -> str:
    return name.split("::", 1)[-1]


def slice_reachability(
    recording: Recording, seed_labels: Sequence[Optional[str]]
) -> List[Dict[str, Witness]]:
    """Input -> output reachability over a recording.

    ``seed_labels[i]`` labels flattened input leaf ``i`` (None: not
    tracked).  Returns, per flattened output leaf, ``{label: Witness}`` for
    every seeded input that can reach it: through every recorded op (each
    output sees every input, as an op's semantics are not modelled), through
    views and in-place versions of a storage, and through the control
    dependence of a host read."""
    if len(seed_labels) != len(recording.input_values):
        raise ValueError(
            f"seed_labels has {len(seed_labels)} entries for "
            f"{len(recording.input_values)} input leaves"
        )
    env: Dict[int, Dict[str, Witness]] = {}
    for vid, lab in zip(recording.input_values, seed_labels):
        if vid is not None and lab is not None:
            env[vid] = _join(env.get(vid, {}), {lab: Witness("<input>", "")})
    control: Dict[str, Witness] = {}
    for op in recording.ops:
        flowed = dict(control)
        for v in op.inputs:
            if v is not None and v in env:
                flowed = _join(flowed, env[v])
        if op.host_read and flowed:
            control = _join(
                control,
                {k: Witness(f"<host-read:{_short(op.name)}>", op.loc, w) for k, w in flowed.items()},
            )
        if not flowed:
            continue
        out = {k: Witness(_short(op.name), op.loc, w) for k, w in flowed.items()}
        for v in op.outputs:
            if v is not None:
                env[v] = _join(env.get(v, {}), out)
    return [dict(env.get(v, {})) if v is not None else {} for v in recording.output_values]
