"""Carry a simulation across between the JAX package and the port.

``state_from_numpy`` takes the fields of a JAX ``SimState`` as numpy arrays
(``{name: np.asarray(getattr(state, name))}``) and returns the port's
``SimState``; ``state_to_numpy`` goes the other way.  uint32 fields (the
per-node ``rng`` keys, ``checksum`` and the ``hist`` counters) become
int32 views of the same bits; an unfused farmhash state carries no record
cache (``rec_bytes`` and ``rec_len`` None), and a plane that is off is
None on both sides.  ``params_from_jax_fields`` maps the protocol
constants, the obs-plane knobs and the kernel knobs of a JAX
``SimParams._asdict()`` onto the port's ``SimParams``.
``scalable_state_from_numpy``, ``scalable_state_to_numpy`` and
``scalable_params_from_jax_fields`` do the same for the scalable engine
(uint32 fields: ``r_delta``, ``rng``, ``checksum``, ``heard``, the 0-d
``base_sum`` and the ``hist``, ``exch`` and ``exch_hist`` planes), and the
``route_*`` functions for the routing plane (``hist`` uint32).

The checkpoint format is the JAX package's: ``DISK_DTYPES`` names the
numpy dtype every field of ``SimState``, ``ScalableState`` and
``RouteCarry`` is stored as, ``state_arrays`` reads a state to the host in
those dtypes (one transfer) and ``state_from_arrays`` builds the port's
state back, refusing any other stored dtype; ``params_to_jax_fields``
gives the ``_asdict()`` a JAX params tuple would have, so a manifest's
``params`` block is the one JAX writes.

Nothing here imports JAX: the arrays are plain numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.ops import u32
from ringpop_tpu_torch.utils.host import to_host

U32_FIELDS = ("rng", "checksum", "hist")

PROTOCOL_FIELDS = (
    "n", "period_ms", "epoch_ms", "suspicion_ticks", "ping_req_size",
    "join_size", "piggyback_factor", "max_digits", "packet_loss",
    "dirty_batch", "checksum_mode", "cell_batch", "gate_phases",
    "flight_recorder", "event_capacity", "histograms",
)


def _dtype_of(name: str, a: np.ndarray) -> torch.dtype:
    if a.dtype == np.bool_:
        return torch.bool
    if name == "rec_bytes":
        return torch.uint8
    return torch.int32


def state_from_numpy(
    arrays: Dict[str, Optional[np.ndarray]], params: engine.SimParams, device="cpu"
) -> engine.SimState:
    """The port's SimState from numpy copies of a JAX SimState's fields."""
    out = {}
    for f in engine.SimState._fields:
        a = arrays.get(f)
        if a is None:
            out[f] = None
            continue
        a = np.asarray(a)
        if f in U32_FIELDS:
            out[f] = u32.from_numpy(a, device)
        else:
            # np.array copies (keeping 0-d fields 0-d) into a writable buffer
            out[f] = torch.as_tensor(np.array(a), dtype=_dtype_of(f, a), device=device)
    if engine.resolve_fused_checksum(params) == "on" and out["rec_bytes"] is None:
        raise ValueError(
            "fused_checksum='on' needs the record cache (rec_bytes, rec_len)"
        )
    return engine.SimState(**out)


def state_to_numpy(state: engine.SimState) -> Dict[str, Optional[np.ndarray]]:
    """numpy copies of every field; uint32 fields as uint32 (one transfer)."""
    return state_arrays(state)


# JAX knob value -> the port's (the same program either way)
FUSED_TICK_MAP = {"off": "off", "xla": "plain", "pallas": "kernel", "auto": "auto"}
HASH_IMPL_MAP = {"scan": "plain", "pallas": "kernel", "pallas_nogrid": "kernel", "env": "auto"}


def params_from_jax_fields(fields: dict) -> engine.SimParams:
    """The port's SimParams for a JAX ``SimParams._asdict()``: the protocol
    constants, the obs-plane knobs, ``parity_recompute`` and
    ``fused_checksum`` carried over as they are; ``fused_tick`` ("xla" ->
    "plain", "pallas" -> "kernel") and ``hash_impl`` ("scan" -> "plain",
    either Pallas loop -> "kernel", "env" -> "auto") mapped onto the port's
    values."""
    kw = {k: fields[k] for k in PROTOCOL_FIELDS if k in fields}
    for knob in ("parity_recompute", "fused_checksum"):
        if knob in fields:
            kw[knob] = fields[knob]
    if "fused_tick" in fields:
        kw["fused_tick"] = FUSED_TICK_MAP[fields["fused_tick"]]
    if "hash_impl" in fields:
        kw["hash_impl"] = HASH_IMPL_MAP[fields["hash_impl"]]
    return engine.SimParams(**kw)


# ---------------------------------------------------------------------------
# the scalable engine

SCALABLE_U32_FIELDS = ("r_delta", "rng", "checksum", "heard", "base_sum", "hist", "exch",
                       "exch_hist")

SCALABLE_PROTOCOL_FIELDS = (
    "n", "u", "ping_req_size", "suspicion_ticks", "piggyback_factor",
    "age_slack", "packet_loss", "epoch", "checksum_in_tick", "enable_leave",
    "gate_phases", "perm_impl", "wavefront", "histograms", "exchange_metrics",
)


def scalable_state_from_numpy(
    arrays: Dict[str, Optional[np.ndarray]], device="cpu"
) -> es.ScalableState:
    """The port's ScalableState from numpy copies of a JAX ScalableState's
    fields (``{name: np.asarray(getattr(state, name))}``)."""
    out = {}
    for f in es.ScalableState._fields:
        a = arrays.get(f)
        if a is None:
            out[f] = None
        elif f in SCALABLE_U32_FIELDS:
            out[f] = u32.from_numpy(a, device).reshape(np.shape(a))
        else:
            a = np.asarray(a)
            dtype = torch.bool if a.dtype == np.bool_ else torch.int32
            out[f] = torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return es.ScalableState(**out)


def scalable_state_to_numpy(state: es.ScalableState) -> Dict[str, Optional[np.ndarray]]:
    """numpy copies of every field; uint32 fields as uint32 (one transfer)."""
    return state_arrays(state)


def scalable_params_from_jax_fields(fields: dict) -> es.ScalableParams:
    """The port's ScalableParams for a JAX ``ScalableParams._asdict()``:
    the protocol constants and the obs-plane knobs carried over;
    ``fused_exchange`` "xla" maps to the plain version, "pallas" to the
    kernel, "off" and "auto" as they are (every mode gives the same
    trajectory)."""
    kw = {k: fields[k] for k in SCALABLE_PROTOCOL_FIELDS if k in fields}
    fe = fields.get("fused_exchange", "auto")
    kw["fused_exchange"] = {"xla": "plain", "pallas": "kernel"}.get(fe, fe)
    return es.ScalableParams(**kw)


# ---------------------------------------------------------------------------
# the routing plane

_RING_STATE_FIELDS = ("seg_keys", "count", "mask", "n_points", "first_owner", "next_owner")
_ROUTE_TRACE_FIELDS = ("req_buf", "req_head", "req_drops", "req_counts", "req_tick")


def route_params_from_jax_fields(fields: dict):
    """The port's RouteParams for a JAX ``RouteParams._asdict()`` (the same
    fields)."""
    from ringpop_tpu_torch.models.route import plane

    return plane.RouteParams(**{k: fields[k] for k in plane.RouteParams._fields if k in fields})


def _flipped(a) -> torch.Tensor:
    """uint64 ring keys -> the port's flipped int64 keys."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64)) ^ np.uint64(1 << 63)
    return torch.from_numpy(a.view(np.int64).copy())


def _as_dict(x) -> dict:
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def route_state_from_numpy(arrays: dict, device="cpu"):
    """The port's RouteState from numpy copies of a JAX RouteState's fields
    (``ring`` a mapping or NamedTuple of the RingState's fields, or None):
    uint64 ring keys become flipped int64, the uint32 ``rng`` and ``hist``
    their int32 views."""
    from ringpop_tpu_torch.models.route import plane
    from ringpop_tpu_torch.models.route import ring_kernel as rk


    def plain(a):
        a = np.asarray(a)
        dtype = torch.bool if a.dtype == np.bool_ else torch.int32
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    ring = None
    if arrays.get("ring") is not None:
        r = _as_dict(arrays["ring"])
        ring = rk.RingState(**{
            f: _flipped(r[f]).to(device) if f == "seg_keys" else plain(r[f])
            for f in _RING_STATE_FIELDS
        })
    out = dict(
        ring=ring,
        flat_ring=None if arrays.get("flat_ring") is None else _flipped(arrays["flat_ring"]).to(device),
        mask=None if arrays.get("mask") is None else plain(arrays["mask"]),
        rng=u32.from_numpy(arrays["rng"], device),
        hist=None if arrays.get("hist") is None else u32.from_numpy(arrays["hist"], device),
    )
    for f in _ROUTE_TRACE_FIELDS:
        out[f] = None if arrays.get(f) is None else plain(arrays[f])
    return plane.RouteState(**out)


def route_state_to_numpy(state) -> dict:
    """numpy arrays of every RouteState field, in the JAX dtypes: ring keys
    uint64, ``rng`` and ``hist`` uint32; ``ring`` a dict of the RingState's
    fields."""
    from ringpop_tpu_torch.models.ring.device import ring_to_numpy

    def plain(t):
        return None if t is None else t.detach().to("cpu").numpy()

    ring = None
    if state.ring is not None:
        ring = {f: plain(getattr(state.ring, f)) for f in _RING_STATE_FIELDS}
        ring["seg_keys"] = ring_to_numpy(state.ring.seg_keys)
    out = dict(
        ring=ring,
        flat_ring=None if state.flat_ring is None else ring_to_numpy(state.flat_ring),
        mask=plain(state.mask),
        rng=u32.to_numpy(state.rng),
        hist=None if state.hist is None else u32.to_numpy(state.hist),
    )
    for f in _ROUTE_TRACE_FIELDS:
        out[f] = plain(getattr(state, f))
    return out


# ---------------------------------------------------------------------------
# the checkpoint format (the JAX package's dtypes and params)


def _disk_dtypes(fields, bools, u32s, u8s=()) -> Dict[str, np.dtype]:
    def dt(f):
        if f in bools:
            return np.dtype(np.bool_)
        if f in u32s:
            return np.dtype(np.uint32)
        if f in u8s:
            return np.dtype(np.uint8)
        return np.dtype(np.int32)

    return {f: dt(f) for f in fields}


# state class name -> {field: the numpy dtype JAX stores it as}
DISK_DTYPES: Dict[str, Dict[str, np.dtype]] = {
    "SimState": _disk_dtypes(
        engine.SimState._fields, {"proc_alive", "ready", "gossip_on", "known", "ch_active"},
        U32_FIELDS, {"rec_bytes"},
    ),
    "ScalableState": _disk_dtypes(
        es.ScalableState._fields, {"proc_alive", "gossip_on", "r_active"}, SCALABLE_U32_FIELDS,
    ),
    "RouteCarry": _disk_dtypes(("mask", "rng"), {"mask"}, {"rng"}),
}


def disk_dtypes(state_cls) -> Dict[str, np.dtype]:
    """The stored dtype of every field of ``state_cls`` (by class name)."""
    name = state_cls if isinstance(state_cls, str) else state_cls.__name__
    if name not in DISK_DTYPES:
        raise TypeError("no checkpoint format for state class %r" % name)
    return DISK_DTYPES[name]


def states_arrays(states: Dict[str, Any]) -> Dict[str, Dict[str, Optional[np.ndarray]]]:
    """Host copies of every field of several states, in their stored
    dtypes (uint32 fields as uint32), read in one transfer.  numpy fields
    pass through as copies; None stays None."""
    flat = [(name, f, getattr(st, f)) for name, st in states.items() for f in st._fields]
    tensors = [v if isinstance(v, torch.Tensor) else None for _, _, v in flat]
    host = to_host(tensors)
    out: Dict[str, Dict[str, Optional[np.ndarray]]] = {name: {} for name in states}
    for (name, f, v), h in zip(flat, host):
        if v is None:
            out[name][f] = None
            continue
        want = disk_dtypes(type(states[name]))[f]
        a = np.array(v, copy=True) if h is None else h
        if a.dtype != want:
            if a.dtype.itemsize != want.itemsize or a.dtype.kind not in "biu":
                raise TypeError("%s.%s is %s, stored as %s" % (name, f, a.dtype, want))
            a = a.view(want)  # the int32 bits of a uint32 field
        out[name][f] = a
    return out


def state_arrays(state) -> Dict[str, Optional[np.ndarray]]:
    """:func:`states_arrays` of one state."""
    return states_arrays({"state": state})["state"]


def state_from_arrays(state_cls, arrays: Dict[str, Optional[np.ndarray]], device="cpu"):
    """The port's ``state_cls`` from stored arrays: uint32 fields become
    int32 views of the same bits, every array is copied into a tensor the
    state owns.  A field whose array is not in its stored dtype raises
    ``TypeError`` (a silent widening or narrowing corrupts a run)."""
    dtypes = disk_dtypes(state_cls)
    out = {}
    for f in state_cls._fields:
        a = arrays.get(f)
        if a is None:
            out[f] = None
            continue
        if a.dtype != dtypes[f]:
            raise TypeError("field %r is %s, the port holds it as %s" % (f, a.dtype, dtypes[f]))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[f] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return state_cls(**out)


# the float params: held as Python floats so they print as JAX's do
_FLOAT_PARAMS = frozenset({"packet_loss", "zipf_s", "multi_key_frac"})


def _json_value(name: str, v):
    if isinstance(v, torch.Tensor):
        raise TypeError("params.%s is a tensor; params hold Python values" % name)
    if isinstance(v, np.generic):
        v = v.item()
    if name in _FLOAT_PARAMS:
        return float(v)
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    raise TypeError("params.%s is %r, not a JSON value" % (name, type(v)))


def params_to_jax_fields(params) -> Dict[str, Any]:
    """The ``_asdict()`` of the JAX params tuple for the port's
    ``SimParams``, ``ScalableParams`` or ``RouteParams`` (the same field
    names): Python values only, floats as floats.  Knobs the port resolves
    to its own values (``fused_tick``, ``hash_impl``, ``fused_exchange``,
    ...) are written as the port holds them; the checkpoint's
    trajectory-neutral set covers every one of them."""
    return {k: _json_value(k, v) for k, v in params._asdict().items()}
