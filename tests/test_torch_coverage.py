"""Completeness guard: for every module pair ``ringpop_tpu/X.py`` <->
``ringpop_tpu_torch/X.py``, each public top-level name and public class
method of the JAX module is in the port's module (defined there or
imported into it) or stands in :data:`ALLOWED` with the reason it is not.
Most of the list is JAX machinery with a stand-in in the port.  A name
ported later must leave the list (the guard fails on a stale entry)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = REPO_ROOT / "ringpop_tpu"
PORT_PKG = REPO_ROOT / "ringpop_tpu_torch"

_CACHE = "drops JAX's jitted executables; torch compiles nothing per shape"
_MANIFEST = "the port's budget prongs share analysis/manifests.py (load, manifest_path)"
_JAXPR = ("walks jaxprs; the port records torch ops with analysis/dataflow.Recorder "
          "(a TorchDispatchMode) instead")
_RANGES = "JAX's jaxpr interval interpreter; the port's ranges run over recorded ops"
_TILES = ("the Pallas row-streaming scaffold for the TPU's VMEM and [8x128] tiles; "
          "the Hopper kernels use real grids")
_SHARDING = ("GSPMD sharding specs and jitted sharded programs; the port's mesh is "
             "in-process lockstep (parallel/comm.lockstep) over per-shard tensors")
_TPU = ("JAX/TPU backend plumbing (pinning, tunnel retries); the port picks its "
        "device with ringpop_tpu_torch.resolve_device")
_BACKEND = ("a tick-cluster backend on the JAX engine; the port's are TorchSimBackend "
            "and TorchScalableBackend")
_XLA_TWIN = "the kernel's XLA twin; the port's plain PyTorch version is its *_plain"


def _methods(cls, names):
    return {"%s.%s" % (cls, m): why for m, why in names.items()}


def _backend(cls):
    return _methods(cls, dict.fromkeys(
        ("destroy", "join_all", "kill", "lookup", "revive", "start", "stats_all", "suspend",
         "tick_all"), _BACKEND))


ALLOWED = {
    "analysis/astlint.py": {
        "CallbackInDeviceRule": "flags JAX host callbacks (pure_callback, debug.print); a "
                                "torch tick has none, and the graph prong counts host reads",
        **_methods("CallbackInDeviceRule", {"applies": "see CallbackInDeviceRule",
                                            "check": "see CallbackInDeviceRule"}),
        "StaleRefAcrossDonationRule": "guards JAX buffer donation (donate_argnums); torch "
                                      "does not donate, the donation prong's "
                                      "inplace-input-write guards the aliasing",
        **_methods("StaleRefAcrossDonationRule", {"applies": "see StaleRefAcrossDonationRule",
                                                  "check": "see StaleRefAcrossDonationRule"}),
        "DTYPE_PATHS": "the port's rules scope themselves by DEVICE_PATHS",
        "SYNC_OK_PATHS": "the port's host-read rule scopes itself by DEVICE_PATHS",
    },
    "analysis/cost.py": {"load_manifest": _MANIFEST, "manifest_path": _MANIFEST},
    "analysis/retrace.py": {"load_manifest": _MANIFEST, "manifest_path": _MANIFEST},
    "analysis/scale_budget.py": {"load_manifest": _MANIFEST, "manifest_path": _MANIFEST},
    "analysis/donation.py": {
        "load_manifest": _MANIFEST, "manifest_path": _MANIFEST,
        "CHEAP_ENTRIES": "JAX's tier-1 subset of compile-heavy entries; the port's record in "
                         "seconds and all run",
        "audit_jit": "reads a jitted function's input_output_alias map; torch does not donate",
        "parse_alias_map": "parses the HLO alias map audit_jit reads",
    },
    "analysis/dataflow.py": {
        "SubJaxpr": _JAXPR, "SubJaxpr.open_": _JAXPR, "Visitor": _JAXPR,
        **_methods("Visitor", dict.fromkeys(("enter_eqn", "eqn_out", "join", "literal",
                                             "measure", "seed_constvar"), _JAXPR)),
        "sub_jaxprs": _JAXPR, "walk": _JAXPR,
    },
    "analysis/kernel_coverage.py": {
        "EXEMPT_MODULES": "exempts ops/toolkit.py's Pallas scaffold; the port's toolkit "
                          "launches no kernel",
    },
    "analysis/ranges.py": {
        "RangeVisitor": _RANGES,
        **_methods("RangeVisitor", dict.fromkeys(("eqn_out", "events", "join", "literal",
                                                  "measure", "seed_constvar"), _RANGES)),
        "analyze_jaxpr": _RANGES, "intersect_hull": "the dtype clamp of RangeVisitor alone",
    },
    "api/tick_cluster.py": {"JaxSimBackend": _BACKEND, "ScalableSimBackend": _BACKEND,
                            **_backend("JaxSimBackend"), **_backend("ScalableSimBackend")},
    "fuzz/executor.py": {
        "clear_executable_cache": _CACHE,
        "scenario_scan_full": "a lax.scan over a scenario batch; the port's executors step "
                              "the vmapped tick in a Python loop",
        "scenario_scan_scalable": "see scenario_scan_full",
    },
    "models/route/plane.py": {"clear_executable_cache": _CACHE},
    "models/sim/cluster.py": {"clear_executable_cache": _CACHE},
    "models/sim/storm.py": {"clear_executable_cache": _CACHE,
                            "donate_state_argnums": "jit donation argnums; torch does not donate"},
    "models/sim/engine_scalable.py": {
        "SHARD_SHARDED_FIELDS": "shard_map's per-shard telemetry fields; each port shard keeps "
                                "its own exch rows (parallel/mesh.Shard.exch_rows)",
    },
    "models/sim/flight.py": {
        "append_events": "the port places every site's candidate lanes in one pass "
                         "(record_tick_events), the same order, so the mesh can split it",
    },
    "ops/exchange.py": {
        "LANE": _TILES, "SUB": _TILES, "TILE": _TILES, "exchange_xla": _XLA_TWIN,
        "measure_bandwidth": "a bandwidth benchmark of the kernel; it belongs to the port "
                             "bench, not the library",
    },
    "ops/fused_apply.py": {"apply_updates_xla": _XLA_TWIN},
    "ops/native.py": {"available": "the port has no pure-Python fallback, so a build error "
                                   "raises from the hash functions"},
    "ops/fused_piggyback.py": {"pb_budget_xla": _XLA_TWIN},
    "ops/toolkit.py": {
        "DEFAULT_VMEM_BUDGET": _TILES, "LANE": _TILES, "SUB": _TILES, "pad_cols": _TILES,
        "pad_rows": _TILES, "pick_row_tile": _TILES, "stream_row_tiles": _TILES,
        "default_interpret": "Pallas interpret mode; on the CPU the port runs plain versions",
        "assert_twin_bitwise": "asserts the xla and pallas impls agree; the port's kernel "
                               "against its plain version runs only on the card (chip_smoke.py)",
        "twins_for_module": "no caller in the port; TWIN_REGISTRY is read whole",
    },
    "parallel/mesh.py": {
        "clear_executable_cache": _CACHE, "inputs_shardings": _SHARDING,
        "make_sharded_scan": _SHARDING, "make_sharded_tick": _SHARDING,
        "scalable_state_shardings": _SHARDING, "shard_state": _SHARDING,
        "state_shardings": _SHARDING,
    },
    "utils/util.py": {
        **dict.fromkeys(
            ("COMPILE_HELPER_MARKERS", "TRANSIENT_BACKEND_MARKERS", "clear_jax_backends",
             "force_host_device_count", "is_compile_helper_500", "is_transient_backend_error",
             "pin_cpu_platform", "reexec_retry", "retry_compile_helper",
             "scrub_repo_pythonpath", "wait_for_tpu"), _TPU),
        "is_empty_array": "no caller in the port",
        "NullStatsd": "no caller in the port; the live node takes it from utils/stats.py",
        **_methods("NullStatsd", dict.fromkeys(("gauge", "increment", "timing"),
                                               "see NullStatsd")),
    },
}


def imported_names(path: Path) -> set:
    return {a.asname or a.name for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ImportFrom) for a in node.names}


def public_names(path: Path) -> set:
    """Public top-level names (defined or assigned) and public methods of
    top-level classes (``Class.method``)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update("%s.%s" % (node.name, sub.name) for sub in node.body
                           if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                out.update(el.id for el in (t.elts if isinstance(t, ast.Tuple) else [t])
                           if isinstance(el, ast.Name))
    return {n for n in out if not any(part.startswith("_") for part in n.split("."))}


def module_pairs():
    return sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py")
                  if (PORT_PKG / p.relative_to(JAX_PKG)).exists())


@pytest.mark.parametrize("rel", module_pairs())
def test_every_public_name_is_ported_or_allowed(rel):
    imported = imported_names(PORT_PKG / rel)  # a class taken in brings its methods
    missing = {name for name in public_names(JAX_PKG / rel) - public_names(PORT_PKG / rel)
               if name.split(".")[0] not in imported}
    allowed = ALLOWED.get(rel, {})
    assert missing - set(allowed) == set(), "ported nowhere and not allowed: %s" % sorted(
        missing - set(allowed))
    assert set(allowed) - missing == set(), "allowed but present (stale entry): %s" % sorted(
        set(allowed) - missing)


def test_allowlist_names_only_module_pairs_and_gives_reasons():
    pairs = set(module_pairs())
    assert set(ALLOWED) <= pairs
    for rel, names in ALLOWED.items():
        for name, why in names.items():
            assert isinstance(why, str) and why.strip() and "\n" not in why, (rel, name)
    assert sum(len(v) for v in ALLOWED.values()) >= 80

