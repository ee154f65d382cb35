"""The port's checkpoint format against the JAX package's, bit for bit.

Three parts:

- every case of tests/models/test_checkpoint.py, run against the port's
  ``models/sim/checkpoint.py`` (resume bitwise, the legacy file's named
  errors, the manifest's round trips, the corruption and version/field
  matrices, shard drift, the ``defame_by`` default, the trajectory-neutral
  knobs, an interrupted save).  Each damaged artifact, written by either
  package, raises the same named ``CheckpointError`` subclass in both;
- cross-loads: ``SimCluster`` n=32 (fast, and farmhash with the port's
  fused record cache), ``ScalableCluster`` n=64 and ``RoutedStorm`` n=64
  (both ring impls), in the legacy file and in manifests of 1, 2 and 4
  shards.  A JAX save loaded by the port, and a port save loaded by JAX,
  each run 4 more ticks beside the saver's own continuation: every state
  field, the route carry and truth ring, and every metric must be equal
  (tolerance: none; ``mean_heard_frac`` too);
- the format: the port's ``manifest.json`` equals JAX's for one state,
  entry for entry (digests, dtypes, shapes, placement, file sizes), but
  for the trajectory-neutral params each package resolves its own way;
  the committed ``runlogs/sample_ckpt_scalable_n8`` deep-verifies and
  loads into the port.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from ringpop_tpu.fuzz import crash as jcrash
from ringpop_tpu.models.route import plane as jplane
from ringpop_tpu.models.sim import checkpoint as jck
from ringpop_tpu.models.sim import engine as je
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.cluster import EventSchedule as JaxEventSchedule
from ringpop_tpu.models.sim.cluster import SimCluster as JaxSimCluster
from ringpop_tpu.models.sim.storm import ScalableCluster as JaxScalableCluster
from ringpop_tpu.models.sim.storm import StormSchedule as JaxStormSchedule
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.fuzz import crash as pcrash
from ringpop_tpu_torch.models.route import plane as pplane
from ringpop_tpu_torch.models.sim import checkpoint as ckpt
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule

REPO_ROOT = os.path.join(os.path.dirname(__file__), "..")
SAMPLE = os.path.join(REPO_ROOT, "runlogs", "sample_ckpt_scalable_n8")


def _assert_states_equal(a, b):
    assert type(a) is type(b)
    x, y = convert.state_arrays(a), convert.state_arrays(b)
    for f in a._fields:
        if x[f] is None:
            assert y[f] is None, f
            continue
        assert x[f].dtype == y[f].dtype, f
        np.testing.assert_array_equal(x[f], y[f], f)


def _scalable_state(n=24, u=160, seed=3, ticks=6):
    """The JAX test's ``_make_state`` on the port's engine."""
    params = es.ScalableParams(n=n, u=u, suspicion_ticks=4)
    state = es.init_state(params, seed=seed, device="cpu")
    rng = np.random.default_rng(0)
    for t in range(ticks):
        kill = np.zeros(n, bool)
        kill[rng.integers(0, n, 2)] = t % 2 == 0
        state, _ = es.tick(state, es.ChurnInputs(kill=torch.as_tensor(kill),
                                                 revive=torch.zeros(n, dtype=torch.bool)),
                           params)
    return params, state


def _jax_params(params):
    return jes.ScalableParams(**convert.params_to_jax_fields(params))


def _jax_state(state):
    """The JAX ScalableState of the port's (numpy fields, uint32 as uint32)."""
    return jes.ScalableState(**convert.state_arrays(state))


# -- the cases of tests/models/test_checkpoint.py on the port's module ------


@pytest.mark.parametrize("fmt", ["legacy", "manifest"])
def test_scalable_resume_bitwise_equal(tmp_path, fmt):
    n = 64
    params = es.ScalableParams(n=n, u=512, packet_loss=0.05, suspicion_ticks=5)
    sched = StormSchedule.churn_storm(40, n, fraction=0.1, fail_tick=2, rejoin_tick=12, seed=4)
    ins = sched.as_inputs("cpu")

    def step(st, t):
        return es.tick(st, type(ins)(*(None if x is None else x[t] for x in ins)), params)[0]

    state = es.init_state(params, seed=3, device="cpu")
    for t in range(20):
        state = step(state, t)
    path = str(tmp_path / ("storm.npz" if fmt == "legacy" else "storm"))
    if fmt == "legacy":
        ckpt.save_state(path, state)
    else:
        ckpt.save_checkpoint(path, state, params, shards=3, sharded_fields=es.NODE_SHARDED_FIELDS)
    cont = state
    for t in range(20, 40):
        cont = step(cont, t)
    resumed = ckpt.load_any(path, es.ScalableState)
    for t in range(20, 40):
        resumed = step(resumed, t)
    _assert_states_equal(cont, resumed)
    assert torch.equal(es.compute_checksums(cont, params), es.compute_checksums(resumed, params))


@pytest.mark.parametrize("mode", ["fast", "farmhash"])
def test_full_engine_resume_bitwise_equal(tmp_path, mode):
    n = 16
    sim = SimCluster(n=n, params=pe.SimParams(n=n, checksum_mode=mode), seed=1, device="cpu")
    sim.bootstrap()
    for _ in range(6):
        sim.step()
    path = str(tmp_path / "sim.npz")
    ckpt.save_state(path, sim.state)
    b = SimCluster(n=n, params=sim.params, seed=4, device="cpu")
    b.load(path)
    for _ in range(8):
        sim.step()
        b.step()
    _assert_states_equal(sim.state, b.state)


def test_checkpoint_rejects_wrong_class_and_fields(tmp_path):
    params = es.ScalableParams(n=8, u=128)
    state = es.init_state(params, device="cpu")
    path = str(tmp_path / "s.npz")
    ckpt.save_state(path, state)
    with pytest.raises(ValueError):
        ckpt.load_state(path, pe.SimState)
    other = str(tmp_path / "other.npz")
    np.savez(other, a=np.zeros(3))
    with pytest.raises(ValueError):
        ckpt.load_state(other, es.ScalableState)
    _assert_states_equal(state, ckpt.load_state(path, es.ScalableState))


@pytest.mark.parametrize("fmt", ["legacy", "manifest"])
def test_stored_dtype_the_port_would_change_is_a_field_error(tmp_path, fmt):
    """An int64 incarnation plane loaded as the port's int32 would wrap
    silently, so any stored dtype other than the field's is a named error
    (and a uint32 field stored as int32 too)."""
    params, state = _scalable_state(n=16)
    arrays = convert.state_arrays(state)
    for field, dtype in (("truth_inc", np.int64), ("checksum", np.int32)):
        bad = dict(arrays, **{field: arrays[field].astype(dtype)})
        path = str(tmp_path / ("%s_%s" % (fmt, field)))
        if fmt == "legacy":
            bad = {k: v for k, v in bad.items() if v is not None}
            bad[ckpt._FORMAT_KEY] = np.array(["ScalableState", str(ckpt._FORMAT_VERSION)])
            np.savez(path + ".npz", **bad)
            path += ".npz"
        else:
            jck.save_checkpoint(path, jes.ScalableState(**bad), _jax_params(params))
        with pytest.raises(ckpt.CheckpointFieldError, match=field):
            ckpt.load_any(path, es.ScalableState, params)


def test_pre_round4_checkpoint_missing_defame_by_loads(tmp_path):
    params, state = _scalable_state(n=32)
    path = str(tmp_path / "old.npz")
    ckpt.save_state(path, state, params)
    data = dict(np.load(path, allow_pickle=True))
    del data["defame_by"]
    np.savez(path, **data)
    loaded = ckpt.load_state(path, es.ScalableState, params)
    assert np.array_equal(loaded.defame_by.numpy(), np.arange(32))
    assert loaded.defame_by.dtype == torch.int32
    for f in es.ScalableState._fields:
        if f != "defame_by" and getattr(state, f) is not None:
            assert torch.equal(getattr(loaded, f), getattr(state, f)), f


def test_hash_impl_is_trajectory_neutral(tmp_path):
    params = pe.SimParams(n=8, checksum_mode="fast", hash_impl="plain")
    state = pe.init_state(params, seed=0, device="cpu")
    path = str(tmp_path / "st.npz")
    ckpt.save_state(path, state, params)
    ckpt.load_state(path, pe.SimState, params._replace(hash_impl="kernel"))
    data = dict(np.load(path, allow_pickle=True))
    saved = json.loads(str(data[ckpt._PARAMS_KEY][0]))
    del saved["hash_impl"]
    data[ckpt._PARAMS_KEY] = np.array([json.dumps(saved)])
    np.savez(path, **data)
    ckpt.load_state(path, pe.SimState, params)


def test_scalable_perm_and_exchange_knobs_are_trajectory_neutral(tmp_path):
    params = es.ScalableParams(n=8, u=128, perm_impl="argsort", fused_exchange="off")
    state = es.init_state(params, seed=0, device="cpu")
    path = str(tmp_path / "st.npz")
    ckpt.save_state(path, state, params)
    # the port's resolved values and JAX's load either way
    ckpt.load_state(path, es.ScalableState,
                    params._replace(perm_impl="sortless", fused_exchange="kernel"))
    jck.load_state(path, jes.ScalableState,
                   _jax_params(params)._replace(perm_impl="sortless", fused_exchange="xla"))
    data = dict(np.load(path, allow_pickle=True))
    saved = json.loads(str(data[ckpt._PARAMS_KEY][0]))
    del saved["perm_impl"]
    del saved["fused_exchange"]
    data[ckpt._PARAMS_KEY] = np.array([json.dumps(saved)])
    np.savez(path, **data)
    ckpt.load_state(path, es.ScalableState, params)


def test_save_state_interrupted_never_shadows_good_checkpoint(tmp_path, monkeypatch):
    params = es.ScalableParams(n=8, u=128)
    good = es.init_state(params, seed=1, device="cpu")
    path = str(tmp_path / "s.npz")
    ckpt.save_state(path, good, params)

    def boom(src, dst):
        raise OSError("killed mid-rename")

    monkeypatch.setattr(ckpt.os, "replace", boom)
    with pytest.raises(OSError):
        ckpt.save_state(path, es.init_state(params, seed=2, device="cpu"), params)
    monkeypatch.undo()
    _assert_states_equal(good, ckpt.load_state(path, es.ScalableState, params))
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f], "tmp protocol not used"


def test_load_state_named_errors(tmp_path):
    params = es.ScalableParams(n=8, u=128)
    path = str(tmp_path / "s.npz")
    ckpt.save_state(path, es.init_state(params, device="cpu"), params)
    with pytest.raises(ckpt.CheckpointNotFoundError):
        ckpt.load_state(str(tmp_path / "absent.npz"), es.ScalableState)
    with pytest.raises(ckpt.CheckpointFieldError):
        ckpt.load_state(path, pe.SimState)
    with pytest.raises(ckpt.CheckpointParamsError):
        ckpt.load_state(path, es.ScalableState, params._replace(suspicion_ticks=99))
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    with pytest.raises(ckpt.CheckpointTornError):
        ckpt.load_state(path, es.ScalableState)
    with pytest.raises(jck.CheckpointTornError):
        jck.load_state(path, jes.ScalableState)


def test_manifest_roundtrip_single_and_sharded(tmp_path):
    params, state = _scalable_state()
    p1, p3, p5 = (str(tmp_path / k) for k in ("ck1", "ck3", "ck5"))
    m1 = ckpt.save_checkpoint(p1, state, params)
    m3 = ckpt.save_checkpoint(p3, state, params, shards=3, sharded_fields=es.NODE_SHARDED_FIELDS)
    assert m1["shards"] == 1 and m3["shards"] == 3
    s1 = ckpt.load_checkpoint(p1, es.ScalableState, params)
    s3 = ckpt.load_checkpoint(p3, es.ScalableState, params)
    _assert_states_equal(state, s1)
    _assert_states_equal(s1, s3)
    ckpt.save_checkpoint(p5, s3, params, shards=5, sharded_fields=es.NODE_SHARDED_FIELDS)
    _assert_states_equal(s1, ckpt.load_checkpoint(p5, es.ScalableState, params))
    ckpt.verify_checkpoint(p5, deep=True)
    jck.verify_checkpoint(p5, deep=True)


def test_manifest_multi_state_roundtrip(tmp_path):
    params, state = _scalable_state(n=16)
    carry = pplane.RouteCarry(mask=torch.as_tensor(np.arange(16) % 3 != 0),
                              rng=torch.tensor([7, -9], dtype=torch.int32))
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, {"sim": state, "route": carry}, {"sim": params, "route": None},
                         shards=2, sharded_fields={"sim": es.NODE_SHARDED_FIELDS,
                                                   "route": frozenset({"mask"})})
    out = ckpt.load_checkpoint(path, {"sim": es.ScalableState, "route": pplane.RouteCarry},
                               {"sim": params, "route": None})
    _assert_states_equal(state, out["sim"])
    _assert_states_equal(carry, out["route"])
    # the carry's rng is stored as JAX stores it: uint32
    assert np.asarray(jck.load_checkpoint(path, {"route": jplane.RouteCarry})["route"].rng).tolist() \
        == [7, 2**32 - 9]
    with pytest.raises(ckpt.CheckpointFieldError):
        ckpt.load_checkpoint(path, {"nope": es.ScalableState})


def _saved(tmp_path, writer, shards=2):
    """One state, saved as a manifest by ``writer`` ("port" or "jax")."""
    params, state = _scalable_state(n=16)
    path = str(tmp_path / ("ck_" + writer))
    sharded = es.NODE_SHARDED_FIELDS if shards > 1 else None
    if writer == "port":
        ckpt.save_checkpoint(path, state, params, shards=shards, sharded_fields=sharded)
    else:
        jck.save_checkpoint(path, _jax_state(state), _jax_params(params), shards=shards,
                            sharded_fields=sharded)
    return params, state, path


def _both_raise(name, path, params):
    """The port and JAX each raise their ``name`` on the same artifact."""
    with pytest.raises(getattr(ckpt, name)):
        ckpt.load_checkpoint(path, es.ScalableState, params)
    with pytest.raises(getattr(jck, name)):
        jck.load_checkpoint(path, jes.ScalableState, None if params is None else _jax_params(params))


def _flip(target, at):
    with open(target, "r+b") as fh:
        fh.seek(at)
        b = fh.read(1)
        fh.seek(at)
        fh.write(bytes([b[0] ^ 0xFF]))


WRITERS = ["port", "jax"]


@pytest.mark.parametrize("writer", WRITERS)
def test_corruption_truncated_array_file_is_torn(tmp_path, writer):
    params, _, path = _saved(tmp_path, writer)
    target = os.path.join(path, "shard-00001-of-00002.npz")
    with open(target, "r+b") as fh:
        fh.truncate(os.path.getsize(target) // 3)
    _both_raise("CheckpointTornError", path, params)
    with pytest.raises(ckpt.CheckpointTornError):
        ckpt.verify_checkpoint(path, deep=False)


@pytest.mark.parametrize("writer", WRITERS)
def test_corruption_flipped_byte_is_digest_mismatch(tmp_path, writer):
    params, _, path = _saved(tmp_path, writer)
    target = os.path.join(path, "common.npz")
    size = os.path.getsize(target)
    _flip(target, size // 2)
    assert os.path.getsize(target) == size
    _both_raise("CheckpointDigestError", path, params)
    with pytest.raises(ckpt.CheckpointDigestError):
        ckpt.verify_checkpoint(path, deep=True)
    ckpt.verify_checkpoint(path, deep=False)  # sizes only: bit-rot is invisible


@pytest.mark.parametrize("writer", WRITERS)
def test_corruption_missing_shard_is_shard_error(tmp_path, writer):
    params, _, path = _saved(tmp_path, writer)
    os.remove(os.path.join(path, "shard-00000-of-00002.npz"))
    _both_raise("CheckpointShardError", path, params)


@pytest.mark.parametrize("writer", WRITERS)
def test_corruption_torn_manifest_and_missing_manifest(tmp_path, writer):
    params, _, path = _saved(tmp_path, writer)
    mpath = os.path.join(path, ckpt.MANIFEST_NAME)
    with open(mpath, "r+b") as fh:
        fh.truncate(os.path.getsize(mpath) // 2)
    _both_raise("CheckpointTornError", path, params)
    os.remove(mpath)
    _both_raise("CheckpointNotFoundError", path, params)
    _both_raise("CheckpointNotFoundError", str(tmp_path / "never"), None)


def _edit_manifest(path, fn):
    mpath = os.path.join(path, ckpt.MANIFEST_NAME)
    with open(mpath, encoding="utf-8") as fh:
        doc = json.load(fh)
    fn(doc)
    with open(mpath, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)


def _add_field(d):
    d["states"]["state"]["fields"]["not_a_field"] = {
        "dtype": "int32", "shape": [1], "where": "common", "crc32": 0}


# drift axis -> (manifest edit, params at load, the named error)
DRIFT = {
    "manifest_version": (lambda d: d.update(version=99), None, "CheckpointVersionError"),
    "engine_version": (lambda d: d.update(engine_version=1), None, "CheckpointVersionError"),
    "params": (None, dict(piggyback_factor=1), "CheckpointParamsError"),
    "field_set": (_add_field, None, "CheckpointFieldError"),
    "shard_list": (lambda d: d.update(shard_files=d["shard_files"][:1]), None,
                   "CheckpointShardError"),
}


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("axis", sorted(DRIFT))
def test_version_and_field_mismatch_matrix(tmp_path, writer, axis):
    """Every drift axis has a named error in both packages, and none of
    them resumes silently."""
    params, _, path = _saved(tmp_path, writer)
    edit, drift, name = DRIFT[axis]
    if edit is not None:
        _edit_manifest(path, edit)
    _both_raise(name, path, params._replace(**(drift or {})))


def test_wrong_class_and_neutral_knobs(tmp_path):
    params, _, path = _saved(tmp_path, "port")
    with pytest.raises(ckpt.CheckpointFieldError):
        ckpt.load_checkpoint(path, pe.SimState, None)
    ckpt.load_checkpoint(path, es.ScalableState,
                         params._replace(gate_phases=False, perm_impl="argsort"))


def test_shard_count_vs_file_list_drift(tmp_path):
    params, _, path = _saved(tmp_path, "port")
    _edit_manifest(path, lambda d: d.update(shard_files=d["shard_files"][:1]))
    with pytest.raises(ckpt.CheckpointShardError):
        ckpt.load_checkpoint(path, es.ScalableState, params)


def test_manifest_defame_by_default_like_legacy(tmp_path):
    params, _, path = _saved(tmp_path, "port", shards=1)
    _edit_manifest(path, lambda d: d["states"]["state"]["fields"].update(defame_by=None))
    common = os.path.join(path, "common.npz")
    data = dict(np.load(common))
    data.pop("state.defame_by")
    ckpt.atomic_write_bytes(common, ckpt._npz_bytes(data))
    with open(common, "rb") as fh:
        buf = fh.read()
    _edit_manifest(path, lambda d: d["files"].update(
        {"common.npz": {"nbytes": len(buf), "crc32": ckpt._crc(buf)}}))
    loaded = ckpt.load_checkpoint(path, es.ScalableState, params)
    assert np.array_equal(loaded.defame_by.numpy(), np.arange(16))


# -- cross-loads: JAX save -> port load, port save -> JAX load ----------------

N_SIM, N_STORM, T_SAVE, T_END = 32, 64, 6, 10
KINDS = ("sim_fast", "sim_farmhash", "scalable", "routed_incremental", "routed_full")
# driver kind -> the crash harness's snapshot kind
SNAP = {"sim_fast": "full", "sim_farmhash": "full", "scalable": "scalable",
        "routed_incremental": "routed", "routed_full": "routed"}


def _route_kw(kind):
    return dict(queries_per_tick=256, key_space=1024, ring_impl=kind.split("_")[1])


def _drivers(kind, seed=1):
    """(JAX driver, port driver) of one kind, from the same seed."""
    if kind.startswith("sim"):
        kw = dict(n=N_SIM, checksum_mode=kind.split("_")[1], suspicion_ticks=6)
        return (JaxSimCluster(n=N_SIM, params=je.SimParams(**kw), seed=seed),
                SimCluster(n=N_SIM, params=pe.SimParams(**kw), seed=seed, device="cpu"))
    kw = dict(n=N_STORM, u=192, suspicion_ticks=4)
    if kind == "scalable":
        return (JaxScalableCluster(n=N_STORM, params=jes.ScalableParams(**kw), seed=seed),
                ScalableCluster(n=N_STORM, params=es.ScalableParams(**kw), seed=seed,
                                device="cpu"))
    return (jplane.RoutedStorm(N_STORM, params=jes.ScalableParams(**kw),
                               route=jplane.RouteParams(n=N_STORM, **_route_kw(kind)), seed=seed),
            pplane.RoutedStorm(N_STORM, params=es.ScalableParams(**kw),
                               route=pplane.RouteParams(n=N_STORM, **_route_kw(kind)), seed=seed,
                               device="cpu"))


def _schedules(kind):
    if kind.startswith("sim"):
        return (JaxEventSchedule.churn_window(T_END, N_SIM),
                EventSchedule.churn_window(T_END, N_SIM))
    kw = dict(ticks=T_END, n=N_STORM, fraction=0.1, fail_tick=1, rejoin_tick=5, seed=3)
    return JaxStormSchedule.churn_storm(**kw), StormSchedule.churn_storm(**kw)


def _jax_ticks(drv, sched, t0, t1):
    """Step the JAX driver over ticks [t0, t1) (one compiled tick, shared
    by every window length); returns the per-tick metrics stacked."""
    ins = sched.as_inputs()
    rows = [drv.step(type(ins)(*(None if x is None else x[t] for x in ins)))
            for t in range(t0, t1)]
    if isinstance(rows[0], tuple) and not hasattr(rows[0], "_fields"):
        return tuple(_stack([r[i] for r in rows]) for i in range(len(rows[0])))
    return _stack(rows)


def _stack(rows):
    return type(rows[0])(*(np.stack([np.asarray(getattr(r, f)) for r in rows])
                           for f in rows[0]._fields))


def _start(drv, kind, run, sched):
    if kind.startswith("sim"):
        drv.bootstrap()
    return run(drv, sched, 0, T_SAVE)


def _save(drv, kind, fmt, path):
    """Save through the driver's own API: ``save`` (the legacy file; a
    manifest for RoutedStorm) or ``enable_checkpoints`` + ``checkpoint_now``."""
    shards = 1 if fmt == "legacy" else int(fmt[1:])
    if kind.startswith("routed"):
        drv.save(path, shards=shards)
        return path
    if fmt == "legacy":
        drv.save(path + ".npz")
        return path + ".npz"
    drv.enable_checkpoints(path, shards=shards)
    return drv.checkpoint_now()


def _snapshots_equal(kind, jd, pd):
    want, got = jcrash.snapshot(SNAP[kind], jd), pcrash.snapshot(SNAP[kind], pd)
    if kind == "sim_farmhash":
        # the port keeps the fused record cache, JAX's CPU pipeline does not
        assert jd.state.rec_bytes is None and pd.state.rec_bytes is not None
        for f in ("state.rec_bytes", "state.rec_len"):
            got.pop(f)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _metrics_equal(jm, pm):
    pairs = zip(jm, pm) if isinstance(jm, tuple) and not hasattr(jm, "_fields") else [(jm, pm)]
    for a, b in pairs:
        for f in a._fields:
            assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f


def _port_ticks(drv, sched, t0, t1):
    return drv.run(sched.window(t0, t1))


CROSS = [(k, f) for k in KINDS for f in (("m1", "m2", "m4") if k.startswith("routed")
                                         else ("legacy", "m1", "m2", "m4"))]


@pytest.mark.parametrize("kind,fmt", CROSS)
def test_jax_checkpoint_resumes_in_the_port(tmp_path, kind, fmt):
    jd, _ = _drivers(kind)
    _, pd = _drivers(kind, seed=9)  # a different start: the load replaces it
    jsched, psched = _schedules(kind)
    _start(jd, kind, _jax_ticks, jsched)
    pd.load(_save(jd, kind, fmt, str(tmp_path / "ck")))
    _snapshots_equal(kind, jd, pd)
    _metrics_equal(_jax_ticks(jd, jsched, T_SAVE, T_END), _port_ticks(pd, psched, T_SAVE, T_END))
    _snapshots_equal(kind, jd, pd)


@pytest.mark.parametrize("kind,fmt", CROSS)
def test_port_checkpoint_resumes_in_jax(tmp_path, kind, fmt):
    _, pd = _drivers(kind)
    jd, _ = _drivers(kind, seed=9)
    jsched, psched = _schedules(kind)
    _start(pd, kind, _port_ticks, psched)
    jd.load(_save(pd, kind, fmt, str(tmp_path / "ck")))
    _metrics_equal(_jax_ticks(jd, jsched, T_SAVE, T_END), _port_ticks(pd, psched, T_SAVE, T_END))
    _snapshots_equal(kind, jd, pd)


# -- the format ---------------------------------------------------------------

# params each package resolves its own way (all trajectory-neutral)
RESOLVED_KNOBS = frozenset({"fused_tick", "hash_impl", "fused_checksum", "parity_recompute",
                            "dirty_batch", "fused_exchange", "perm_impl", "ring_impl",
                            "bucket_bits"})


@pytest.mark.parametrize("kind,shards", [("sim_farmhash", 1), ("sim_fast", 2),
                                         ("scalable", 1), ("scalable", 2),
                                         ("routed_incremental", 4)])
def test_manifest_equals_jax_entry_for_entry(tmp_path, monkeypatch, kind, shards):
    """One state, saved by each package through its driver: the manifests
    agree on every digest, dtype, shape, placement and file size; the
    params differ only in the knobs each package resolves for itself."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)  # the zip members' timestamps
    jd, pd = _drivers(kind)
    jsched, psched = _schedules(kind)
    _start(jd, kind, _jax_ticks, jsched)
    _start(pd, kind, _port_ticks, psched)
    docs = []
    for drv in (jd, pd):
        path = str(tmp_path / ("ck%d" % len(docs)))
        if kind.startswith("routed"):
            drv.save(path, shards=shards)
        else:
            drv.enable_checkpoints(path, shards=shards)
            path = drv.checkpoint_now()
        with open(os.path.join(path, ckpt.MANIFEST_NAME)) as fh:
            docs.append(json.load(fh))
    want, got = docs
    if kind == "sim_farmhash":  # the port's fused cache: two more arrays in common.npz
        for f in ("rec_bytes", "rec_len"):
            assert want["states"]["state"]["fields"][f] is None
            got["states"]["state"]["fields"][f] = None
        got.pop("files"), want.pop("files"), got.pop("nbytes"), want.pop("nbytes")
    differs = set()
    for name in want["states"]:
        wp, gp = want["states"][name].pop("params"), got["states"][name].pop("params")
        assert sorted(wp) == sorted(gp)
        differs |= {k for k in wp if wp[k] != gp[k]}
    assert differs <= RESOLVED_KNOBS <= ckpt._TRAJECTORY_NEUTRAL_PARAMS
    assert got == want


def test_committed_sample_loads_into_the_port():
    manifest = ckpt.verify_checkpoint(SAMPLE, deep=True)
    assert manifest["shards"] == 2
    params = es.ScalableParams(n=8, u=128, suspicion_ticks=4)
    state = ckpt.load_checkpoint(SAMPLE, es.ScalableState, params)
    want = jck.load_checkpoint(SAMPLE, jes.ScalableState, jes.ScalableParams(
        n=8, u=128, suspicion_ticks=4))
    got = convert.state_arrays(state)
    for f in jes.ScalableState._fields:
        w = getattr(want, f)
        assert (w is None and got[f] is None) or np.array_equal(got[f], np.asarray(w)), f
    c = ScalableCluster(n=8, params=params, device="cpu")
    c.load(SAMPLE)
    c.step()
    assert int(c.state.tick_index) == int(state.tick_index) + 1
