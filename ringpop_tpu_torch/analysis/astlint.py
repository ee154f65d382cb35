"""The ``ast`` prong: an AST lint over ``ringpop_tpu_torch/``.

Counterpart of ``ringpop_tpu/analysis/astlint.py``, with the same
machinery (:class:`ModuleInfo`, tick contexts inferred to a fixpoint,
local taint, :class:`Rule` classes) and each rule in its torch form:

=====================  ==================================================
rule                   invariant
=====================  ==================================================
host-coerce            no ``int()/float()/bool()`` and no ``.item()/
                       .tolist()/.cpu()/.numpy()`` on a tensor inside a
                       tick context (a device-to-host read: one sync on
                       the card).  The answers of a shard body's
                       collectives are exempt: :data:`COLLECTIVE_ANSWERS`
np-on-traced           no ``np.*`` call on a tensor inside a tick context
                       (a silent device-to-host copy)
implicit-dtype         no ``torch.where(c, a, b)`` with two Python scalars
                       (int64 or float32, whatever the planes are), and no
                       ``torch.zeros/ones/full/empty/arange/tensor`` without
                       ``dtype=`` in the device paths
implicit-accum-dtype   no ``sum/cumsum/prod/cumprod`` without ``dtype=`` in
                       the device paths unless the operand is pinned to a
                       float or to int64: torch accumulates int and bool
                       in int64
py-random-time         no global ``random``/``time``/``np.random`` state in
                       a tick context, and no global torch or numpy RNG
                       (``torch.rand*`` without ``generator=``) anywhere in
                       the device paths; explicit generators are fine
mutable-default        no mutable or tensor-valued default argument
block-until-ready      no ``torch.cuda.synchronize()`` or
                       ``.synchronize()`` in the device paths (it
                       serialises the card's queue); obs/ may sync
assert-on-traced       no ``assert`` over a tensor inside a tick context
                       (``bool()`` of a tensor: a host read)
inplace-on-state       no in-place method (``x.add_()``), ``out=`` argument
                       or subscript assignment on a tensor bound from the
                       tick's input state: the bounded-parity replay
                       re-runs the ``pre`` state the tick was given
                       (``models/sim/cluster.py`` ``_run_schedule``), so a
                       write through it corrupts the replay — the torch form
                       of JAX's stale-ref-across-donation
=====================  ==================================================

Two JAX rules have no torch form:

- ``callback-in-device``: eager PyTorch has no host-callback primitive
  (``io_callback``, ``pure_callback``, ``jax.debug.print``); every line of a
  tick runs on the host already, and what a callback cost in JAX (a host
  round trip inside the device program) is a host read here, which
  ``host-coerce`` and the graph prong's ``host-sync`` catch;
- ``stale-ref-across-donation``: nothing in the port donates a buffer (no
  ``donate_argnums``; every tick returns new tensors), so no binding can
  outlive its buffer.  The hazard that remains is the reverse one, a write
  through a binding into state another holder still reads, which
  ``inplace-on-state`` checks.

Tick contexts — where the tensor rules apply — are inferred per module:
functions named in :data:`TRACED_ENTRIES` (the port's tick roots and
kernel wrappers, called from other modules), functions passed to
``vmap``/``custom_op``/``register_vmap`` or decorated by them, every
``def`` nested inside a context, and (to a fixpoint) every
module-level function called by name from one.  A ``# torchgate: host``
comment on the ``def`` line opts a host helper out.

Tensors are approximated by local taint: function parameters (except those
annotated as a Python scalar, a string, or a ``*Params`` / ``Universe``
constant) and the results of ``torch`` calls, propagated through
assignments; shape, dtype and device reads carry no taint.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from ringpop_tpu_torch.analysis import findings as fmod
from ringpop_tpu_torch.analysis.findings import Finding

PKG = "ringpop_tpu_torch/"

# tick roots called from other modules: module suffix -> function names
TRACED_ENTRIES: Dict[str, Set[str]] = {
    # the shard bodies of both engines and the ticks that run them alone
    "models/sim/engine.py": {"tick", "shard_tick", "compute_checksums"},
    "models/sim/engine_scalable.py": {
        "tick", "shard_tick", "compute_checksums", "farmhash_truth_checksum",
    },
    "models/sim/flight.py": {"record_tick_events"},
    "models/sim/batched.py": {"vmap_tick"},
    "models/route/plane.py": {"route_tick", "init_route_state"},
    "models/route/reqtrace.py": {"record_tick_requests"},
    "models/route/ring_kernel.py": {"full_rebuild", "update", "lookup"},
    # (device.lookup_n walks successors on the host by design: not a root)
    "models/ring/device.py": {"build_ring", "lookup"},
    "parallel/mesh.py": {"make_exchange_plane"},
    # the fuzz executors' ticks, vmapped over the instances by run_schedules
    "fuzz/executor.py": {"_tick"},
    # the kernel wrappers and their plain versions
    "ops/fused_apply.py": {"apply_updates", "apply_updates_plain"},
    "ops/fused_piggyback.py": {"pb_budget", "pb_budget_plain"},
    "ops/stream_hash.py": {"fused_stream", "fused_stream_plain"},
    "ops/block_loop.py": {"block_loop", "block_loop_plain"},
    "ops/exchange.py": {"exchange", "exchange_plain", "exchange_local"},
    # the hash and checksum ops the ticks call across modules
    "ops/farmhash.py": {"hash32_rows"},
    "ops/fused_checksum.py": {"membership_checksums", "member_records", "member_records_at",
                              "member_records_plain"},
    "ops/checksum_encode.py": {"membership_rows"},
    "ops/histogram.py": {"record", "record_count"},
}

# The host side of a shard body's collectives: the loop that answers the
# ``pred`` and ``counts`` yields reads the predicate on the host by design
# (one read a gated phase), as does the mesh's combiner.  Module suffix ->
# functions (None: the whole module).
COLLECTIVE_ANSWERS: Dict[str, Optional[Set[str]]] = {
    "models/sim/engine_scalable.py": {"run_solo", "host_read"},
    "parallel/comm.py": None,
}

# device modules: code on (or feeding) the card's path; obs/ and the
# harnesses at the package root may sync and read
DEVICE_PATHS = ("ops/", "models/", "parallel/", "fuzz/")

_CONTEXT_WRAPPERS = {"vmap", "custom_op", "register_vmap"}
_COERCERS = {"int", "float", "bool", "complex"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_DTYPE_CTORS = {"zeros", "ones", "full", "empty", "arange", "tensor"}
_ACCUM = {"sum", "cumsum", "prod", "cumprod"}
# operand pins that make the accumulator visible: a float stays a float,
# int64 is what torch accumulates in anyway
_PINS = {"float", "double", "half", "bfloat16", "long"}
_PIN_DTYPES = {"float", "float16", "float32", "float64", "double", "half", "bfloat16",
               "int64", "long"}
# methods and attributes that give static metadata, not tensor values
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "names"}
_STATIC_METHODS = {"size", "numel", "dim", "stride", "element_size", "data_ptr",
                   "is_contiguous", "nelement", "get_device"}
_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "complex", "bytes"}
_EXPLICIT_GENERATORS = {"default_rng", "Generator", "RandomState", "SeedSequence",
                        "PCG64", "Random", "SystemRandom"}
_TORCH_GLOBAL_RNG = {"rand", "randn", "randint", "randperm", "rand_like", "randn_like",
                     "randint_like", "normal", "bernoulli", "multinomial", "poisson",
                     "manual_seed", "seed"}
_STATE_PARAMS = {"state", "states", "rstate", "st"}


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain ('torch.cuda.synchronize')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _names_in(node: ast.AST) -> Set[str]:
    """Names referenced by ``node``, except those reached only through
    static metadata (``x.shape[0]``, ``x.numel()`` are host math)."""
    out: Set[str] = set()

    def visit(n: ast.AST) -> None:
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            return
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in _STATIC_METHODS
        ):
            return
        if isinstance(n, ast.Name):
            out.add(n.id)
        for child in ast.iter_child_nodes(n):
            visit(child)

    visit(node)
    return out


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk ``fn``'s body, stopping at nested function boundaries (a nested
    def is a context of its own with its own rule pass)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _scalar_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    chain = _attr_chain(ann) or ""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        chain = ann.value
    leaf = chain.rsplit(".", 1)[-1]
    return (
        leaf in _SCALAR_ANNOTATIONS
        or leaf.endswith("Params")
        or leaf == "Universe"
        or chain.split(".", 1)[0] in ("np", "numpy")
    )


class ModuleInfo:
    """Parsed module plus the shared analyses the rules consume."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel  # relative to the package root's parent (posix)
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.lines = source.splitlines()
        self.suppressions = fmod.parse_suppressions(source)
        self.host_lines = fmod.host_marked_lines(source)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        self.functions: List[ast.AST] = [
            n
            for n in ast.walk(self.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        ]
        self.constants = self._module_constants()
        self.tick_contexts: Set[ast.AST] = self._infer_tick_contexts()
        self._taint_cache: Dict[ast.AST, Set[str]] = {}

    @property
    def pkg_rel(self) -> str:
        """The path inside the package ('models/sim/engine.py')."""
        return self.rel.split(PKG, 1)[-1]

    def in_paths(self, paths: Tuple[str, ...]) -> bool:
        return self.pkg_rel.startswith(paths)

    def _module_constants(self) -> Dict[str, object]:
        """Module-level names bound to a Python number (``ALIVE = 0``,
        ``A, B = 1, 2``)."""
        out: Dict[str, object] = {}
        for node in self.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                pairs = []
                if isinstance(t, ast.Name):
                    pairs = [(t, node.value)]
                elif isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple):
                    pairs = list(zip(t.elts, node.value.elts))
                for name, val in pairs:
                    num = _number(val)
                    if isinstance(name, ast.Name) and num is not None:
                        out[name.id] = num
        return out

    # -- tick-context inference -------------------------------------------

    def _is_host_marked(self, fn: ast.AST) -> bool:
        return getattr(fn, "lineno", 0) in self.host_lines

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return cur
            cur = self._parents.get(cur)
        return None

    def _decorated(self, fn: ast.AST) -> bool:
        for dec in getattr(fn, "decorator_list", []):
            target = dec.func if isinstance(dec, ast.Call) else dec
            leaf = (_attr_chain(target) or "").rsplit(".", 1)[-1]
            if leaf in _CONTEXT_WRAPPERS:
                return True
        return False

    def _infer_tick_contexts(self) -> Set[ast.AST]:
        by_name: Dict[str, List[ast.AST]] = {}
        module_level: Dict[str, ast.AST] = {}
        for fn in self.functions:
            name = getattr(fn, "name", None)
            if name:
                by_name.setdefault(name, []).append(fn)
                if isinstance(self._parents.get(fn), ast.Module):
                    module_level[name] = fn

        roots: Set[ast.AST] = {fn for fn in self.functions if self._decorated(fn)}
        for suffix, names in TRACED_ENTRIES.items():
            if self.rel.endswith(suffix):
                for name in names:
                    roots.update(by_name.get(name, []))
        for call in ast.walk(self.tree):
            if not isinstance(call, ast.Call):
                continue
            leaf = (_attr_chain(call.func) or "").rsplit(".", 1)[-1]
            if leaf not in _CONTEXT_WRAPPERS:
                continue
            for arg in list(call.args) + [k.value for k in call.keywords]:
                if isinstance(arg, ast.Lambda):
                    roots.add(arg)
                elif isinstance(arg, ast.Name) and arg.id in by_name:
                    roots.update(by_name[arg.id])
        roots = {fn for fn in roots if not self._is_host_marked(fn)}

        contexts = set(roots)
        changed = True
        while changed:
            changed = False
            for fn in self.functions:
                if fn in contexts or self._is_host_marked(fn):
                    continue
                enc = self.enclosing_function(fn)
                if enc is not None and enc in contexts:
                    contexts.add(fn)
                    changed = True
            for fn in list(contexts):
                for call in ast.walk(fn):
                    if isinstance(call, ast.Call) and isinstance(call.func, ast.Name):
                        callee = module_level.get(call.func.id)
                        if (
                            callee is not None
                            and callee not in contexts
                            and not self._is_host_marked(callee)
                        ):
                            contexts.add(callee)
                            changed = True
        return contexts

    def collective_answer(self, fn: ast.AST) -> bool:
        """Whether ``fn`` (or a function enclosing it) answers a shard
        body's collectives on the host (:data:`COLLECTIVE_ANSWERS`)."""
        for suffix, names in COLLECTIVE_ANSWERS.items():
            if not self.rel.endswith(suffix):
                continue
            if names is None:
                return True
            cur = fn
            while cur is not None:
                if getattr(cur, "name", None) in names:
                    return True
                cur = self.enclosing_function(cur)
        return False

    # -- tensor taint ------------------------------------------------------

    def traced_names(self, fn: ast.AST) -> Set[str]:
        """Names in ``fn`` that (approximately) hold tensors: parameters
        plus torch-derived assignments, to a fixpoint."""
        cached = self._taint_cache.get(fn)
        if cached is not None:
            return cached
        taint: Set[str] = set()
        args = fn.args
        for a in (
            list(args.posonlyargs)
            + list(args.args)
            + list(args.kwonlyargs)
            + ([args.vararg] if args.vararg else [])
            + ([args.kwarg] if args.kwarg else [])
        ):
            if a.arg not in ("self", "cls") and not _scalar_annotation(a.annotation):
                taint.add(a.arg)

        def rhs_tainted(expr: ast.AST) -> bool:
            if _names_in(expr) & taint:
                return True
            for sub in ast.walk(expr):
                if isinstance(sub, ast.Call):
                    chain = _attr_chain(sub.func) or ""
                    if chain.split(".", 1)[0] == "torch" and not chain.startswith(
                        ("torch.Size", "torch.device", "torch.dtype")
                    ):
                        return True
            return False

        def bind_targets(target: ast.AST) -> Iterator[str]:
            for sub in ast.walk(target):
                if isinstance(sub, ast.Name):
                    yield sub.id

        changed = True
        while changed:
            changed = False
            for node in ast.walk(fn):
                targets: List[ast.AST] = []
                if isinstance(node, ast.Assign) and rhs_tainted(node.value):
                    targets = list(node.targets)
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and (
                    node.value is not None and rhs_tainted(node.value)
                ):
                    targets = [node.target]
                elif isinstance(node, ast.For) and rhs_tainted(node.iter):
                    targets = [node.target]
                for t in targets:
                    for name in bind_targets(t):
                        if name not in taint:
                            taint.add(name)
                            changed = True
        self._taint_cache[fn] = taint
        return taint

    def scope_taint(self, fn: ast.AST) -> Set[str]:
        """Tensor names visible in ``fn``, closure captures included."""
        taint = set(self.traced_names(fn))
        enc = self.enclosing_function(fn)
        while enc is not None:
            taint |= self.traced_names(enc)
            enc = self.enclosing_function(enc)
        return taint

    def src(self, node: ast.AST) -> str:
        line = getattr(node, "lineno", 0)
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


def _has_dtype(call: ast.Call) -> bool:
    """Whether a call passes ``dtype=`` (or ``**kwargs``, which may)."""
    return any(k.arg in ("dtype", None) for k in call.keywords)


def _number(node: ast.AST):
    """The value of a Python number literal (``3``, ``-1``, ``0.5``)."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        inner = _number(node.operand)
        return None if inner is None else (-inner if isinstance(node.op, ast.USub) else inner)
    if (
        isinstance(node, ast.Constant)
        and isinstance(node.value, (int, float))
        and not isinstance(node.value, bool)
    ):
        return node.value
    return None


# ---------------------------------------------------------------------------
# rule framework


class Rule:
    name: str = ""
    summary: str = ""
    scope: str = PKG  # human-readable scope note

    def applies(self, mod: ModuleInfo) -> bool:
        return True

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mod: ModuleInfo, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.name,
            path=mod.rel,
            line=getattr(node, "lineno", 0),
            message=message,
            prong="ast",
            source=mod.src(node),
            end_line=getattr(node, "end_lineno", 0) or 0,
        )

    @staticmethod
    def context_functions(mod: ModuleInfo) -> Iterator[ast.AST]:
        """The tick-context functions the tensor rules look into."""
        for fn in mod.functions:
            if fn in mod.tick_contexts and not mod.collective_answer(fn):
                yield fn


class HostCoerceRule(Rule):
    name = "host-coerce"
    summary = (
        "int()/float()/bool() or .item()/.tolist()/.cpu()/.numpy() on a "
        "tensor inside a tick context reads it on the host (a sync on the card)"
    )
    scope = "tick contexts"

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for fn in self.context_functions(mod):
            taint = mod.scope_taint(fn)
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Name) and node.func.id in _COERCERS:
                    hit = node.args and _names_in(node.args[0]) & taint
                    if hit:
                        yield self.finding(
                            mod, node,
                            f"{node.func.id}() of tensor {sorted(hit)}: a host read — "
                            "keep it on the device or yield it to the shard loop",
                        )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_METHODS
                    and _names_in(node.func.value) & taint
                ):
                    yield self.finding(
                        mod, node,
                        f".{node.func.attr}() of a tensor copies it to the host",
                    )


class NpOnTracedRule(Rule):
    name = "np-on-traced"
    summary = "np.* on a tensor inside a tick context copies it to the host"
    scope = "tick contexts"

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for fn in self.context_functions(mod):
            taint = mod.scope_taint(fn)
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func) or ""
                if chain.split(".", 1)[0] not in ("np", "numpy"):
                    continue
                hit: Set[str] = set()
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    hit |= _names_in(arg) & taint
                if hit:
                    yield self.finding(
                        mod, node,
                        f"{chain}() on tensor {sorted(hit)}: use the torch op",
                    )


class ImplicitDtypeRule(Rule):
    name = "implicit-dtype"
    summary = (
        "torch.where with two Python scalars (int64 or float32 out), or a "
        "torch constructor without dtype=, breaks int32/uint32 discipline"
    )
    scope = "ops/, models/, parallel/, fuzz/"

    def applies(self, mod: ModuleInfo) -> bool:
        return mod.in_paths(DEVICE_PATHS)

    def _scalar(self, mod: ModuleInfo, node: ast.AST) -> bool:
        if _number(node) is not None:
            return True
        return isinstance(node, ast.Name) and node.id in mod.constants

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            parts = (_attr_chain(node.func) or "").split(".")
            if len(parts) != 2 or parts[0] != "torch":
                continue
            if parts[1] == "where" and len(node.args) == 3:
                if self._scalar(mod, node.args[1]) and self._scalar(mod, node.args[2]):
                    yield self.finding(
                        mod, node,
                        "torch.where(c, scalar, scalar) takes torch's default dtype "
                        "(int64 / float32): make one branch a tensor of the plane's dtype",
                    )
            elif parts[1] in _DTYPE_CTORS and not _has_dtype(node):
                yield self.finding(mod, node, f"torch.{parts[1]}(...) without dtype=")


class ImplicitAccumDtypeRule(Rule):
    name = "implicit-accum-dtype"
    summary = (
        "sum/cumsum/prod/cumprod without dtype=: torch accumulates int and "
        "bool in int64 — pass dtype= (or pin the operand to a float or int64)"
    )
    scope = "ops/, models/, parallel/, fuzz/"

    def applies(self, mod: ModuleInfo) -> bool:
        return mod.in_paths(DEVICE_PATHS)

    @staticmethod
    def _pinned(op: Optional[ast.AST]) -> bool:
        if not (isinstance(op, ast.Call) and isinstance(op.func, ast.Attribute)):
            return False
        if op.func.attr in _PINS:
            return True
        if op.func.attr == "to" and op.args:
            leaf = (_attr_chain(op.args[0]) or "").rsplit(".", 1)[-1]
            return leaf in _PIN_DTYPES
        return False

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        fns = [fn for fn in mod.functions if not isinstance(fn, ast.Lambda)]
        for fn in fns:
            taint = mod.scope_taint(fn)
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call) or _has_dtype(node):
                    continue
                chain = _attr_chain(node.func) or ""
                parts = chain.split(".")
                if len(parts) == 2 and parts[0] == "torch" and parts[1] in _ACCUM:
                    op = node.args[0] if node.args else None
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _ACCUM
                    and chain.split(".", 1)[0] not in ("np", "numpy", "math", "torch")
                    and _names_in(node.func.value) & taint
                ):
                    op = node.func.value
                else:
                    continue
                if self._pinned(op):
                    continue
                what = chain if parts[0] == "torch" else "." + node.func.attr
                yield self.finding(
                    mod, node,
                    f"{what}(...) without dtype=: an int or bool operand "
                    "accumulates in int64",
                )


class PyRandomTimeRule(Rule):
    name = "py-random-time"
    summary = (
        "global random/time/np.random state in a tick context, or the "
        "global torch/numpy RNG in a device path: thread an explicit generator"
    )
    scope = "tick contexts; ops/, models/, parallel/, fuzz/"

    _MODULES = ("random", "time", "datetime", "numpy.random", "torch")

    def _aliases(self, mod: ModuleInfo) -> Dict[str, str]:
        """local alias -> fully qualified origin."""
        out: Dict[str, str] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom):
                if node.module in self._MODULES:
                    for alias in node.names:
                        out[alias.asname or alias.name] = f"{node.module}.{alias.name}"
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name in self._MODULES and alias.asname:
                        out[alias.asname] = alias.name
        return out

    @staticmethod
    def _global_state(chain: str, in_context: bool, call: ast.Call) -> bool:
        parts = chain.split(".")
        leaf = parts[-1]
        if chain.startswith(("np.random.", "numpy.random.", "random.")):
            return leaf not in _EXPLICIT_GENERATORS
        if chain.startswith("torch.") and len(parts) == 2 and leaf in _TORCH_GLOBAL_RNG:
            return not any(k.arg == "generator" for k in call.keywords)
        if not in_context:
            return False
        if chain.startswith("time."):
            return True
        return chain.startswith("datetime.") and leaf in ("now", "utcnow", "today")

    def applies(self, mod: ModuleInfo) -> bool:
        return mod.in_paths(DEVICE_PATHS) or bool(mod.tick_contexts)

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        aliases = self._aliases(mod)
        device = mod.in_paths(DEVICE_PATHS)
        contexts = set(self.context_functions(mod))
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func) or ""
            if not chain:
                continue
            head, _, rest = chain.partition(".")
            if head in aliases:
                chain = aliases[head] + (f".{rest}" if rest else "")
            fn = mod.enclosing_function(node)
            in_context = fn in contexts
            if not (device or in_context):
                continue
            if self._global_state(chain, in_context, node):
                yield self.finding(
                    mod, node,
                    f"{chain}() reads global random or clock state: thread an "
                    "explicit generator or stamp instead",
                )


class MutableDefaultRule(Rule):
    name = "mutable-default"
    summary = (
        "mutable or tensor-valued default argument: one instance is shared "
        "across calls (and a tensor default is built at import)"
    )

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for fn in mod.functions:
            args = fn.args
            for default in list(args.defaults) + [d for d in args.kw_defaults if d is not None]:
                bad = None
                if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                    bad = "mutable literal"
                elif isinstance(default, ast.Call):
                    chain = _attr_chain(default.func) or ""
                    root = chain.split(".", 1)[0]
                    if root in ("np", "numpy") or (
                        root == "torch"
                        and not chain.startswith(("torch.device", "torch.Size", "torch.dtype"))
                    ):
                        bad = f"array constructor {chain}()"
                    elif chain in ("list", "dict", "set", "bytearray"):
                        bad = f"{chain}()"
                if bad:
                    yield self.finding(
                        mod, default,
                        f"default argument is a {bad}: use None and build it in the function",
                    )


class BlockUntilReadyRule(Rule):
    name = "block-until-ready"
    summary = (
        "torch.cuda.synchronize()/.synchronize() in a device path serialises "
        "the card's queue; only obs and the harnesses may sync"
    )
    scope = "ops/, models/, parallel/, fuzz/"

    def applies(self, mod: ModuleInfo) -> bool:
        return mod.in_paths(DEVICE_PATHS)

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "synchronize"
            ):
                yield self.finding(mod, node, "synchronize() in a device path")


class AssertOnTracedRule(Rule):
    name = "assert-on-traced"
    summary = (
        "assert over a tensor inside a tick context reads it on the host "
        "every tick"
    )
    scope = "tick contexts"

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for fn in self.context_functions(mod):
            taint = mod.scope_taint(fn)
            for node in _own_nodes(fn):
                if isinstance(node, ast.Assert):
                    hit = _names_in(node.test) & taint
                    if hit:
                        yield self.finding(
                            mod, node,
                            f"assert over tensor {sorted(hit)}: validate on the host "
                            "side, outside the tick",
                        )


class InplaceOnStateRule(Rule):
    name = "inplace-on-state"
    summary = (
        "in-place method, out= or subscript assignment on a tensor bound from "
        "the tick's input state corrupts the state a replay re-runs"
    )
    scope = "tick contexts in ops/, models/, parallel/, fuzz/"

    def applies(self, mod: ModuleInfo) -> bool:
        return mod.in_paths(DEVICE_PATHS)

    @staticmethod
    def _state_params(fn: ast.AST) -> Set[str]:
        args = fn.args
        return {
            a.arg
            for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
            if a.arg in _STATE_PARAMS
        }

    @staticmethod
    def _rooted(node: ast.AST, names: Set[str]) -> Optional[str]:
        """The state-bound name a bare Name/Attribute/Subscript chain
        starts from (``state.known[0]`` -> 'state'), else None."""
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        if isinstance(node, ast.Name) and node.id in names:
            return node.id
        return None

    def _check_fn(self, mod: ModuleInfo, fn: ast.AST, params: Set[str]) -> Iterator[Finding]:
        # aliases: a bare binding of the state or one of its fields (no
        # call in between: a call such as .clone() makes a new tensor);
        # a later rebind from anything else ends the alias
        bound: Dict[str, List[Tuple[int, bool]]] = {p: [(0, True)] for p in params}
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign):
                alias = self._rooted(node.value, set(params)) is not None and not isinstance(
                    node.value, ast.Name
                ) or (isinstance(node.value, ast.Name) and node.value.id in params)
                for t in node.targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
                            bound.setdefault(sub.id, []).append((node.lineno, alias))

        def live(name: str, line: int) -> bool:
            hist = [b for b in bound.get(name, []) if b[0] <= line]
            return bool(hist) and max(hist)[1]

        def state_name(node: ast.AST, line: int) -> Optional[str]:
            root = self._rooted(node, set(bound))
            return root if root is not None and live(root, line) else None

        for node in _own_nodes(fn):
            if isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr.endswith("_")
                    and not node.func.attr.startswith("_")
                ):
                    who = state_name(node.func.value, node.lineno)
                    if who is not None:
                        yield self.finding(
                            mod, node,
                            f".{node.func.attr}() writes in place through '{who}', "
                            "which is bound from the tick's input state",
                        )
                for k in node.keywords:
                    if k.arg == "out":
                        who = state_name(k.value, node.lineno)
                        if who is not None:
                            yield self.finding(
                                mod, node,
                                f"out= writes through '{who}', which is bound from "
                                "the tick's input state",
                            )
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        who = state_name(t.value, node.lineno)
                        if who is not None:
                            yield self.finding(
                                mod, node,
                                f"subscript assignment writes through '{who}', which "
                                "is bound from the tick's input state",
                            )

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for fn in self.context_functions(mod):
            if isinstance(fn, ast.Lambda):
                continue
            params = self._state_params(fn)
            if params:
                yield from self._check_fn(mod, fn, params)


ALL_RULES: List[Rule] = [
    HostCoerceRule(),
    NpOnTracedRule(),
    ImplicitDtypeRule(),
    ImplicitAccumDtypeRule(),
    PyRandomTimeRule(),
    MutableDefaultRule(),
    BlockUntilReadyRule(),
    AssertOnTracedRule(),
    InplaceOnStateRule(),
]

RULES_BY_NAME: Dict[str, Rule] = {r.name: r for r in ALL_RULES}


def lint_source(
    source: str,
    rel: str,
    path: Optional[Path] = None,
    rules: Optional[Iterable[Rule]] = None,
    respect_suppressions: bool = True,
) -> List[Finding]:
    """Lint one module's source; returns the unsuppressed findings."""
    mod = ModuleInfo(path or Path(rel), rel, source)
    out: List[Finding] = []
    for rule in ALL_RULES if rules is None else rules:
        if not rule.applies(mod):
            continue
        for f in rule.check(mod):
            if respect_suppressions and fmod.is_suppressed(f, mod.suppressions):
                continue
            out.append(f)
    return out


def lint_paths(
    root: Path,
    files: Optional[Iterable[Path]] = None,
    rules: Optional[Iterable[Rule]] = None,
) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (or just ``files``); paths in
    findings are relative to ``root``'s parent."""
    base = root.parent
    targets = (
        sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)
        if files is None
        else [Path(f) for f in files]
    )
    explicit = files is not None
    out: List[Finding] = []
    for path in targets:
        try:
            rel = path.resolve().relative_to(base.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        try:
            source = path.read_text()
        except (OSError, UnicodeDecodeError) as e:
            if explicit:
                # a typo'd target must not read as clean
                out.append(Finding(
                    rule="unreadable-file", path=rel, line=0,
                    message=f"could not read explicit lint target: {e}", prong="ast"))
            continue
        try:
            out.extend(lint_source(source, rel, path=path, rules=rules))
        except SyntaxError as e:
            out.append(Finding(
                rule="syntax-error", path=rel, line=e.lineno or 0,
                message=f"could not parse: {e.msg}", prong="ast"))
    return out
