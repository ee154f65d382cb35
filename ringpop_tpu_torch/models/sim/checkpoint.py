"""Array-state checkpoints for long simulator runs: the JAX package's format.

Counterpart of ``ringpop_tpu/models/sim/checkpoint.py``, and the same
on-disk format: a checkpoint written by either package loads into the
other and continues the same trajectory bit for bit.  The
preemption-safety story is the JAX module's:

- the **legacy single-file format** (``save_state``/``load_state``): one
  ``.npz`` per state, written through tmp + fsync + ``os.replace`` so an
  interrupted save never shadows a previous good checkpoint;
- the **manifest format** (``save_checkpoint``/``load_checkpoint``): a
  checkpoint directory of ``common.npz`` and, sharded,
  ``shard-%05d-of-%05d.npz`` array files, and a ``manifest.json`` written
  LAST with per-file and per-array CRC32 digests, shapes, dtypes, params
  and meta.  A directory without a valid manifest is not a checkpoint;
  truncation, bit-rot, missing shards and format drift each raise a
  named :class:`CheckpointError` instead of a silently corrupt resume.
  Node-axis fields may be split over shards and restore onto any shard
  count.

The module works on numpy at its edges.  A state to save may hold
tensors (read to the host in one transfer, ``convert.states_arrays``) or
numpy arrays; every field is stored in the dtype JAX stores it in
(``convert.DISK_DTYPES``: uint32 bits as uint32), and params as the JSON
of the JAX ``_asdict()`` (``convert.params_to_jax_fields``).  A load
returns the port's state of tensors on ``device`` (the CPU unless asked),
each a copy the state owns; a stored dtype the port would load as
anything else is a :class:`CheckpointFieldError`.  Rotation, cadence and
newest-valid discovery live in :mod:`ringpop_tpu_torch.models.sim.recovery`.
"""

from __future__ import annotations

import io
import json
import os
import time
import zlib
from typing import Any, Dict, List, Mapping, Optional, Type, TypeVar

import numpy as np

from ringpop_tpu_torch import convert

T = TypeVar("T", bound=tuple)

_FORMAT_KEY = "__ringpop_tpu_state__"
_PARAMS_KEY = "__ringpop_tpu_params__"
# params that tune performance without touching the trajectory — a resume
# may change these freely, and a checkpoint from a build predating one of
# them must still load (its absence on either side is ignored)
_TRAJECTORY_NEUTRAL_PARAMS = frozenset(
    {
        "dirty_batch",
        "checksum_in_tick",
        "gate_phases",
        "hash_impl",
        "parity_recompute",
        # fused parity pipeline: bitwise-identical checksums (pinned by
        # tests/ops/test_fused_checksum.py), so a resume may toggle it —
        # the record cache is rebuilt from (known, status, inc) on load
        "fused_checksum",
        "cell_batch",
        # fused full-fidelity tick: bitwise-identical
        # trajectories in every mode (tests/models/test_fused_tick.py),
        # and drivers pin backend-resolved values at construction — a
        # TPU-saved checkpoint (fused_tick="pallas") must load on a CPU
        # resume ("xla"/"off"), and older checkpoints lack the key
        "fused_tick",
        # flight recorder / wavefront tracing: write-only telemetry
        # planes, trajectory-neutral by construction (nothing in the
        # protocol reads them) — a resume may toggle or resize freely;
        # the drivers rebuild/drop the buffers on load
        "flight_recorder",
        "event_capacity",
        "wavefront",
        # latency-histogram plane: same write-only telemetry
        # contract as the flight recorder — counters start fresh on a
        # toggled resume (fixup_sim_state / fixup_scalable_state /
        # RoutedStorm._rebuild_route_state)
        "histograms",
        # per-shard exchange telemetry plane: write-only like
        # the histograms — a resume may toggle or re-shard freely and
        # fixup_scalable_state re-zeroes the counters
        "exchange_metrics",
        # the scalable hot path: both knobs are bit-identical by
        # the gate-equivalence tests (tests/models/test_scalable_perm.py),
        # and drivers pin backend-resolved values at construction — a
        # TPU-saved checkpoint (fused_exchange="pallas") must load on a
        # CPU resume ("off"), and older checkpoints lack the keys
        "perm_impl",
        "fused_exchange",
        # routing plane (RouteParams): the ring REPRESENTATION is not
        # part of the checkpointed carry — RoutedStorm persists only the
        # membership mask + rng and rebuilds the bucketed (or flat) ring
        # under its own impl/caps on load, bit-identically
        # (tests/models/test_route_plane.py roundtrip)
        "ring_impl",
        "bucket_bits",
        "max_changed",
        "max_dirty",
        # request observatory: the sampled per-request trace
        # plane is write-only like the flight recorder — a resume may
        # toggle sampling or resize the buffer freely;
        # RoutedStorm._rebuild_route_state opens a fresh trace window
        "reqtrace",
        "req_capacity",
        "req_sample_log2",
        "req_salt",
    }
)
# v2: incarnation fields are int32 tick stamps (engine.stamp_to_ms), not
# int64 epoch-ms values — a v1 checkpoint's ms incarnations would be
# silently misread as stamps, so loads reject version mismatches
_FORMAT_VERSION = 2
# fields added after checkpoints of the same format version shipped:
# loadable with a derived default (sibling field supplies shape/dtype).
# defame_by (scalable engine): defaulting to the node's own id
# makes the refute reachability gate (partition[defame_by] == partition)
# vacuously true, i.e. an older checkpoint's defamed nodes refute
# on the old, laxer rule — inside the envelope the new field narrows.
_FIELD_DEFAULTS = {
    "defame_by": (
        "defame_slot",
        lambda arr: np.arange(arr.shape[0], dtype=arr.dtype),
    ),
}

# -- named load-failure taxonomy --------------------------------------------
# All subclass ValueError so callers catching ValueError keep
# working; the recovery scan (recovery.CheckpointManager) catches
# CheckpointError specifically and falls back past the corrupt artifact.


class CheckpointError(ValueError):
    """Base: this path does not hold a loadable checkpoint."""


class CheckpointNotFoundError(CheckpointError):
    """No checkpoint here at all (missing path/manifest, foreign file)."""


class CheckpointTornError(CheckpointError):
    """Partial/interrupted write: truncated file, unparseable manifest,
    or an archive ``np.load`` cannot open."""


class CheckpointDigestError(CheckpointError):
    """Content digest mismatch at full length — bit-rot or tampering."""


class CheckpointShardError(CheckpointError):
    """Sharded-manifest inconsistency: missing shard file or shard
    list/count drift."""


class CheckpointVersionError(CheckpointError):
    """Format version mismatch (a cross-version resume would silently
    corrupt the trajectory)."""


class CheckpointFieldError(CheckpointError):
    """State class / field set / dtype does not match the resuming
    engine's."""


class CheckpointParamsError(CheckpointError):
    """Trajectory-relevant params differ between save and resume."""


# -- atomic writes -----------------------------------------------------------


def _fsync_dir(dirpath: str) -> None:
    """Best-effort fsync of a directory so the rename itself is durable
    (platforms without directory fds just skip)."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp + fsync + ``os.replace``: ``path`` either keeps its previous
    content or holds all of ``data`` — never a prefix.  The tmp file
    lives in the same directory (rename must not cross filesystems) and
    carries a ``.tmp.<pid>`` suffix the checkpoint scanners ignore."""
    path = os.fspath(path)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    return bio.getvalue()


def _crc(buf: bytes) -> int:
    return zlib.crc32(buf) & 0xFFFFFFFF


def _array_crc(arr: np.ndarray) -> int:
    return _crc(np.ascontiguousarray(arr).tobytes())


# -- legacy single-file format ----------------------------------------------


def save_state(path: str, state: Any, params: Any = None) -> None:
    """Write a NamedTuple-of-arrays engine state to ``path``.

    ``params`` (the engine's SimParams/ScalableParams NamedTuple) is stored
    alongside so a resume can verify it runs under the same protocol
    constants.  The literal path is used — no silent ``.npz`` suffixing —
    so ``save(p)`` / ``load(p)`` always round-trip.  The write is atomic
    (tmp + fsync + ``os.replace``): an interrupted save never shadows a
    previous good checkpoint with a torn file.
    """
    if getattr(state, "_fields", None) is None:
        raise TypeError("state must be a NamedTuple of arrays")
    # optional fields (e.g. the fused record cache) may be None — they
    # are simply not stored; load_state restores their None default, and
    # derived caches are rebuilt by the driver (SimCluster.load)
    arrays = {
        name: arr for name, arr in convert.state_arrays(state).items() if arr is not None
    }
    arrays[_FORMAT_KEY] = np.array(
        [type(state).__name__, str(_FORMAT_VERSION)]
    )
    if params is not None:
        arrays[_PARAMS_KEY] = np.array(
            [json.dumps(convert.params_to_jax_fields(params), sort_keys=True)]
        )
    atomic_write_bytes(path, _npz_bytes(arrays))


def _params_jsonable(params: Any) -> Any:
    return json.loads(json.dumps(convert.params_to_jax_fields(params), sort_keys=True))


def _check_params(saved_params: Any, params: Any, where: str) -> None:
    """Raise CheckpointParamsError when trajectory-relevant params differ
    (the _TRAJECTORY_NEUTRAL_PARAMS set may differ freely on either
    side)."""
    saved = dict(saved_params)
    current = _params_jsonable(params)
    for neutral in _TRAJECTORY_NEUTRAL_PARAMS:
        saved.pop(neutral, None)
        current.pop(neutral, None)
    if saved != current:
        diff = {
            k: (saved.get(k), current.get(k))
            for k in set(saved) | set(current)
            if saved.get(k) != current.get(k)
        }
        raise CheckpointParamsError(
            "%s: checkpoint params differ from the resuming engine's "
            "(saved, current): %r" % (where, diff)
        )


def _reconcile_fields(
    state_cls: Type[T], available: Dict[str, Any], where: str, device: Any = "cpu"
) -> T:
    """Shared field-matching half of both load paths: missing/extra field
    detection, derived defaults for fields added post-ship
    (_FIELD_DEFAULTS), optional (None-default) fields, and the
    dtype-truncation guard.  ``available`` maps field name -> np array
    (fields stored as None simply absent)."""
    optional = set(getattr(state_cls, "_field_defaults", {}))
    missing = [
        f
        for f in state_cls._fields
        if f not in available and f not in _FIELD_DEFAULTS and f not in optional
    ]
    extra = [f for f in available if f not in state_cls._fields]
    if missing or extra:
        raise CheckpointFieldError(
            "%s: checkpoint fields do not match %s (missing=%r, extra=%r)"
            % (where, state_cls.__name__, missing, extra)
        )
    dtypes = convert.disk_dtypes(state_cls)
    arrays: Dict[str, Optional[np.ndarray]] = {}
    for f in state_cls._fields:
        if f not in available:
            if f in _FIELD_DEFAULTS:
                sibling, default_of = _FIELD_DEFAULTS[f]
                # dtype comes from the stored sibling array by design
                arrays[f] = default_of(np.asarray(available[sibling]))
            else:  # optional field: its NamedTuple default (None)
                arrays[f] = state_cls._field_defaults[f]
            continue
        src = np.asarray(available[f])
        if src.dtype != dtypes[f]:
            # e.g. int64 incarnations (a v1-era or foreign writer): the
            # port would narrow them to its int32 field and silently wrap
            raise CheckpointFieldError(
                "%s: checkpoint field %r is %s but this engine holds it "
                "as %s" % (where, f, src.dtype, dtypes[f])
            )
        arrays[f] = src
    # every tensor is a copy the state owns: a later in-place tick must
    # never write through to numpy memory (or the reverse)
    return convert.state_from_arrays(state_cls, arrays, device)


def load_state(
    path: str, state_cls: Type[T], params: Any = None, device: Any = "cpu"
) -> T:
    """Rebuild ``state_cls`` from a checkpoint written by ``save_state``
    (its tensors on ``device``).

    Mismatched fields (older engine revision) or — when both sides provide
    them — mismatched params raise named :class:`CheckpointError`
    subclasses rather than resuming a silently wrong trajectory.
    """
    if not os.path.exists(path):
        raise CheckpointNotFoundError("%s does not exist" % path)
    try:
        ctx = np.load(path, allow_pickle=False)
    except Exception as e:
        raise CheckpointTornError(
            "%s is not a readable npz archive (truncated or partial "
            "write?): %s" % (path, e)
        )
    with ctx as data:
        meta = data.get(_FORMAT_KEY)
        if meta is None:
            raise CheckpointNotFoundError(
                "%s is not a ringpop_tpu checkpoint" % path
            )
        saved_name = str(meta[0])
        if saved_name != state_cls.__name__:
            raise CheckpointFieldError(
                "checkpoint holds %s, expected %s" % (saved_name, state_cls.__name__)
            )
        saved_version = int(meta[1]) if len(meta) > 1 else 0
        if saved_version != _FORMAT_VERSION:
            raise CheckpointVersionError(
                "checkpoint format v%d, this build reads v%d (incarnation "
                "representation changed; a cross-version resume would "
                "silently corrupt the trajectory)"
                % (saved_version, _FORMAT_VERSION)
            )
        if params is not None and _PARAMS_KEY in data.files:
            _check_params(
                json.loads(str(data[_PARAMS_KEY][0])), params, path
            )
        try:
            available = {
                f: data[f]
                for f in data.files
                if f not in (_FORMAT_KEY, _PARAMS_KEY)
            }
        except Exception as e:
            raise CheckpointTornError(
                "%s: array member unreadable (truncated archive?): %s"
                % (path, e)
            )
        return _reconcile_fields(state_cls, available, path, device)


# -- manifest format ---------------------------------------------------------

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = "ringpop-tpu-ckpt"
MANIFEST_VERSION = 1
_COMMON_FILE = "common.npz"


def _shard_file(s: int, shards: int) -> str:
    return "shard-%05d-of-%05d.npz" % (s, shards)


def _as_state_map(states: Any) -> Dict[str, Any]:
    if hasattr(states, "_fields"):
        return {"state": states}
    if isinstance(states, Mapping):
        for name, st in states.items():
            if not hasattr(st, "_fields"):
                raise TypeError(
                    "state %r must be a NamedTuple of arrays" % name
                )
        return dict(states)
    raise TypeError("states must be a NamedTuple or a dict of NamedTuples")


def _per_state(value: Any, names, what: str) -> Dict[str, Any]:
    """Broadcast a singleton (params / sharded_fields) over state names,
    or validate an explicit per-state mapping."""
    if isinstance(value, Mapping) and not hasattr(value, "_fields"):
        unknown = set(value) - set(names)
        if unknown:
            raise ValueError("%s for unknown states %r" % (what, unknown))
        return {n: value.get(n) for n in names}
    return {n: value for n in names}


def save_checkpoint(
    path: str,
    states: Any,
    params: Any = None,
    *,
    shards: int = 1,
    sharded_fields: Any = None,
    meta: Optional[Dict[str, Any]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """Write a manifest-format checkpoint directory at ``path``.

    ``states`` is one NamedTuple-of-arrays (stored under the name
    ``"state"``) or a dict of them (e.g. RoutedStorm's ``{"sim": ...,
    "route": ...}``); ``params``/``sharded_fields`` may be singletons or
    per-state dicts.  With ``shards > 1``, every field named in
    ``sharded_fields`` is split along axis 0 into per-shard files
    (``np.array_split`` — restorable onto ANY shard count since the
    loader reassembles full arrays); everything else lands in
    ``common.npz``.  Every array file is written atomically, and
    ``manifest.json`` — carrying per-file and per-array CRC32 digests —
    is written LAST: the manifest IS the commit point, so a crash at any
    earlier byte leaves no valid checkpoint at ``path`` (the recovery
    scan skips it and falls back).  Returns the manifest dict.

    Tensor fields are read to the host in one transfer; ``timings``, when
    given, receives the seconds spent on that read (``device_to_host_s``),
    on building the archives and their digests (``serialise_crc_s``) and
    on the atomic writes (``write_fsync_s``).
    """
    if shards < 1:
        raise ValueError("shards must be >= 1, got %d" % shards)
    state_map = _as_state_map(states)
    params_map = _per_state(params, state_map, "params")
    shard_map = _per_state(sharded_fields, state_map, "sharded_fields")
    os.makedirs(path, exist_ok=True)
    clock = time.perf_counter
    spent = {"device_to_host_s": 0.0, "serialise_crc_s": 0.0, "write_fsync_s": 0.0}
    t0 = clock()
    host = convert.states_arrays(state_map)
    spent["device_to_host_s"] = clock() - t0
    t0 = clock()

    common: Dict[str, np.ndarray] = {}
    shard_arrays: List[Dict[str, np.ndarray]] = [{} for _ in range(shards)]
    manifest_states: Dict[str, Any] = {}
    for name, state in state_map.items():
        split = frozenset(shard_map[name] or ()) if shards > 1 else frozenset()
        fields: Dict[str, Any] = {}
        for f in state._fields:
            arr = host[name][f]
            if arr is None:
                fields[f] = None  # optional field: restored as None
                continue
            key = "%s.%s" % (name, f)
            entry = {
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
            }
            if f in split and arr.ndim >= 1:
                pieces = np.array_split(arr, shards, axis=0)
                for s, piece in enumerate(pieces):
                    shard_arrays[s][key] = piece
                entry["where"] = "shards"
                entry["crc32"] = [_array_crc(p) for p in pieces]
            else:
                common[key] = arr
                entry["where"] = "common"
                entry["crc32"] = _array_crc(arr)
            fields[f] = entry
        p = params_map[name]
        manifest_states[name] = {
            "class": type(state).__name__,
            "params": None if p is None else _params_jsonable(p),
            "fields": fields,
        }

    files: Dict[str, Any] = {}
    total = 0

    def _commit(fname: str, arrays: Dict[str, np.ndarray]) -> None:
        nonlocal total, t0
        buf = _npz_bytes(arrays)
        files[fname] = {"nbytes": len(buf), "crc32": _crc(buf)}
        total += len(buf)
        t1 = clock()
        spent["serialise_crc_s"] += t1 - t0
        atomic_write_bytes(os.path.join(path, fname), buf)
        t0 = clock()
        spent["write_fsync_s"] += t0 - t1

    _commit(_COMMON_FILE, common)
    shard_names = []
    for s in range(shards) if shards > 1 else ():
        fname = _shard_file(s, shards)
        _commit(fname, shard_arrays[s])
        shard_names.append(fname)

    manifest = {
        "format": MANIFEST_FORMAT,
        "version": MANIFEST_VERSION,
        "engine_version": _FORMAT_VERSION,
        "shards": shards,
        "common": _COMMON_FILE,
        "shard_files": shard_names,
        "files": files,
        "states": manifest_states,
        "nbytes": total,
        "meta": dict(meta or {}),
    }
    doc = json.dumps(manifest, sort_keys=True, indent=1).encode("utf-8")
    t1 = clock()
    spent["serialise_crc_s"] += t1 - t0
    atomic_write_bytes(os.path.join(path, MANIFEST_NAME), doc)
    spent["write_fsync_s"] += clock() - t1
    if timings is not None:
        timings.update(spent)
    return manifest


def load_any(
    path: str, state_cls: Type[T], params: Any = None, device: Any = "cpu"
) -> T:
    """Format-dispatching single-state load: a directory is a manifest
    checkpoint, a file the legacy npz — the drivers' ``load(path)``
    entry point, so an operator can hand either artifact kind to any
    driver."""
    if os.path.isdir(path):
        return load_checkpoint(path, state_cls, params, device)
    return load_state(path, state_cls, params, device)


def read_manifest(path: str) -> Dict[str, Any]:
    """Parse + format-check ``path``'s manifest (no array I/O).  Raises
    the named taxonomy: missing -> NotFound, unparseable -> Torn,
    foreign format -> NotFound, version drift -> Version."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.isdir(path) or not os.path.exists(mpath):
        raise CheckpointNotFoundError(
            "%s holds no %s — not a (complete) checkpoint" % (path, MANIFEST_NAME)
        )
    try:
        with open(mpath, encoding="utf-8") as fh:
            manifest = json.load(fh)
    except (ValueError, OSError) as e:
        raise CheckpointTornError(
            "%s: manifest unparseable (interrupted write?): %s" % (path, e)
        )
    if not isinstance(manifest, dict) or manifest.get("format") != MANIFEST_FORMAT:
        raise CheckpointNotFoundError(
            "%s: manifest is not %r" % (path, MANIFEST_FORMAT)
        )
    if manifest.get("version") != MANIFEST_VERSION:
        raise CheckpointVersionError(
            "%s: manifest format v%r, this build reads v%d"
            % (path, manifest.get("version"), MANIFEST_VERSION)
        )
    if manifest.get("engine_version") != _FORMAT_VERSION:
        raise CheckpointVersionError(
            "%s: engine state format v%r, this build reads v%d "
            "(incarnation representation changed; a cross-version resume "
            "would silently corrupt the trajectory)"
            % (path, manifest.get("engine_version"), _FORMAT_VERSION)
        )
    shard_names = manifest.get("shard_files", [])
    shards = manifest.get("shards", 1)
    if shards > 1 and len(shard_names) != shards:
        raise CheckpointShardError(
            "%s: manifest names %d shard files for shards=%d"
            % (path, len(shard_names), shards)
        )
    return manifest


def _verify_file(path: str, fname: str, entry: Dict[str, Any], deep: bool) -> None:
    fpath = os.path.join(path, fname)
    is_shard = fname.startswith("shard-")
    if not os.path.exists(fpath):
        err = CheckpointShardError if is_shard else CheckpointTornError
        raise err("%s: missing array file %s" % (path, fname))
    size = os.path.getsize(fpath)
    if size != entry["nbytes"]:
        raise CheckpointTornError(
            "%s: %s is %d bytes, manifest says %d (truncated/partial write)"
            % (path, fname, size, entry["nbytes"])
        )
    if deep:
        with open(fpath, "rb") as fh:
            buf = fh.read()
        if _crc(buf) != entry["crc32"]:
            raise CheckpointDigestError(
                "%s: %s content digest mismatch (bit-rot or tampering: "
                "crc32 %08x != manifest %08x)"
                % (path, fname, _crc(buf), entry["crc32"])
            )


def verify_checkpoint(path: str, deep: bool = True) -> Dict[str, Any]:
    """Validate a manifest-format checkpoint without constructing states.

    ``deep=False``: manifest parse + file existence + exact sizes (the
    rotation scan's cheap validity probe).  ``deep=True``: additionally
    re-verify every file AND per-array digest (the CI validator).  Raises
    the named error; returns the manifest when valid."""
    manifest = read_manifest(path)
    names = [manifest["common"]] + list(manifest.get("shard_files", []))
    for fname in names:
        entry = manifest["files"].get(fname)
        if entry is None:
            raise CheckpointShardError(
                "%s: manifest lists no digest for %s" % (path, fname)
            )
        _verify_file(path, fname, entry, deep)
    if deep:
        _load_arrays(path, manifest)  # per-array digests + shapes
    return manifest


def _open_npz(path: str, fname: str, entry: Optional[Dict[str, Any]] = None):
    """Open an array file, verifying the manifest's whole-file digest
    first when given: ANY flipped byte on disk — array data, npy header
    padding, zip structure — is a named CheckpointDigestError before
    numpy parses a single byte."""
    fpath = os.path.join(path, fname)
    try:
        with open(fpath, "rb") as fh:
            buf = fh.read()
    except OSError as e:
        raise CheckpointTornError("%s: %s unreadable: %s" % (path, fname, e))
    if entry is not None:
        if len(buf) != entry["nbytes"]:
            raise CheckpointTornError(
                "%s: %s is %d bytes, manifest says %d (truncated/partial "
                "write)" % (path, fname, len(buf), entry["nbytes"])
            )
        if _crc(buf) != entry["crc32"]:
            raise CheckpointDigestError(
                "%s: %s content digest mismatch (bit-rot or tampering: "
                "crc32 %08x != manifest %08x)"
                % (path, fname, _crc(buf), entry["crc32"])
            )
    try:
        return np.load(io.BytesIO(buf), allow_pickle=False)
    except Exception as e:
        raise CheckpointTornError(
            "%s: %s unreadable as npz (truncated?): %s" % (path, fname, e)
        )


def _read_member(arch, path: str, key: str) -> np.ndarray:
    """Extract one npz member, folding the zip layer's own failure modes
    into the named taxonomy (zipfile raises BadZipFile mid-read on its
    per-member CRC — flipped bits — and assorted errors on truncated
    members)."""
    import zipfile

    try:
        return arch[key]
    except Exception as e:
        if isinstance(e, zipfile.BadZipFile) and "CRC" in str(e):
            raise CheckpointDigestError(
                "%s: member %r content digest mismatch (flipped bits on "
                "disk?): %s" % (path, key, e)
            )
        raise CheckpointTornError(
            "%s: member %r unreadable (truncated archive?): %s"
            % (path, key, e)
        )


def _load_arrays(
    path: str, manifest: Dict[str, Any]
) -> Dict[str, Dict[str, np.ndarray]]:
    """Read + digest-verify every stored array; reassemble sharded fields
    by concatenation along axis 0.  Returns {state: {field: array}}."""
    shards = manifest.get("shards", 1)
    files = manifest.get("files", {})
    archives = {
        _COMMON_FILE: _open_npz(
            path, manifest["common"], files.get(manifest["common"])
        )
    }
    for fname in manifest.get("shard_files", []):
        archives[fname] = _open_npz(path, fname, files.get(fname))
    try:
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for sname, sdesc in manifest["states"].items():
            fields: Dict[str, np.ndarray] = {}
            for f, entry in sdesc["fields"].items():
                if entry is None:
                    continue  # stored None: optional-field default
                key = "%s.%s" % (sname, f)
                if entry["where"] == "shards":
                    pieces = []
                    for s in range(shards):
                        arch = archives[manifest["shard_files"][s]]
                        if key not in arch.files:
                            raise CheckpointShardError(
                                "%s: shard %d holds no %r" % (path, s, key)
                            )
                        piece = _read_member(arch, path, key)
                        if _array_crc(piece) != entry["crc32"][s]:
                            raise CheckpointDigestError(
                                "%s: field %r shard %d digest mismatch "
                                "(flipped bits on disk?)" % (path, key, s)
                            )
                        pieces.append(piece)
                    arr = np.concatenate(pieces, axis=0) if pieces else None
                else:
                    arch = archives[_COMMON_FILE]
                    if key not in arch.files:
                        raise CheckpointTornError(
                            "%s: common file holds no %r" % (path, key)
                        )
                    arr = _read_member(arch, path, key)
                    if _array_crc(arr) != entry["crc32"]:
                        raise CheckpointDigestError(
                            "%s: field %r digest mismatch (flipped bits "
                            "on disk?)" % (path, key)
                        )
                if list(arr.shape) != entry["shape"] or str(arr.dtype) != entry["dtype"]:
                    raise CheckpointFieldError(
                        "%s: field %r is %s%r, manifest says %s%r"
                        % (
                            path,
                            key,
                            arr.dtype,
                            arr.shape,
                            entry["dtype"],
                            tuple(entry["shape"]),
                        )
                    )
                fields[f] = arr
            out[sname] = fields
        return out
    finally:
        for arch in archives.values():
            arch.close()


def load_checkpoint(
    path: str, state_cls: Any, params: Any = None, device: Any = "cpu"
) -> Any:
    """Rebuild state(s) from a manifest-format checkpoint directory.

    ``state_cls`` is a NamedTuple type (returns one state) or a dict
    name -> type matching the saved layout (returns a dict of states);
    ``params`` likewise; the tensors land on ``device``.  Every file and array digest is re-verified —
    truncation raises :class:`CheckpointTornError`, flipped bits
    :class:`CheckpointDigestError`, missing shards
    :class:`CheckpointShardError`, and class/field/params drift their
    named errors — never a silent resume."""
    single = hasattr(state_cls, "_fields")
    cls_map = {"state": state_cls} if single else dict(state_cls)
    manifest = read_manifest(path)
    for fname in [manifest["common"]] + list(manifest.get("shard_files", [])):
        _verify_file(path, fname, manifest["files"][fname], deep=False)
    params_map = _per_state(params, cls_map, "params")
    for name, cls in cls_map.items():
        sdesc = manifest["states"].get(name)
        if sdesc is None:
            raise CheckpointFieldError(
                "%s: checkpoint holds states %r, requested %r"
                % (path, sorted(manifest["states"]), name)
            )
        if sdesc["class"] != cls.__name__:
            raise CheckpointFieldError(
                "%s: state %r holds %s, expected %s"
                % (path, name, sdesc["class"], cls.__name__)
            )
        extra = [f for f in sdesc["fields"] if f not in cls._fields]
        if extra:
            raise CheckpointFieldError(
                "%s: state %r carries fields %r unknown to %s (newer "
                "engine revision?)" % (path, name, extra, cls.__name__)
            )
        p = params_map[name]
        if p is not None and sdesc.get("params") is not None:
            _check_params(sdesc["params"], p, "%s[%s]" % (path, name))
    arrays = _load_arrays(path, manifest)
    out = {
        name: _reconcile_fields(
            cls, arrays[name], "%s[%s]" % (path, name), device
        )
        for name, cls in cls_map.items()
    }
    return out["state"] if single else out
