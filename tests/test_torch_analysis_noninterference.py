"""The ``noninterference`` prong of the port's analysis: every obs entry
is clean on the tree; the seeded leaks of the JAX prong's tests are
caught with a named op chain; obs-to-obs and obs-to-metrics flows are
allowed; an unclassified field is a finding; and the port's field
registries equal JAX's, each total and disjoint over its state class."""

from __future__ import annotations

import unittest.mock as mock

import pytest
import torch

from ringpop_tpu.analysis import noninterference as jni
from ringpop_tpu.models.route import plane as jplane
from ringpop_tpu.models.sim import engine as jengine
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu_torch.analysis import graph_audit as ga
from ringpop_tpu_torch.analysis import noninterference as ni
from ringpop_tpu_torch.analysis.findings import render_text
from ringpop_tpu_torch.models.route import plane
from ringpop_tpu_torch.models.sim import engine, engine_scalable as es
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

BY_NAME = ga.ENTRIES_BY_NAME

REGISTRIES = [
    (engine.SimState, engine.SIM_TRAJECTORY_FIELDS, engine.SIM_OBS_ONLY_FIELDS,
     jengine.SIM_TRAJECTORY_FIELDS, jengine.SIM_OBS_ONLY_FIELDS),
    (es.ScalableState, es.SCALABLE_TRAJECTORY_FIELDS, es.SCALABLE_OBS_ONLY_FIELDS,
     jes.SCALABLE_TRAJECTORY_FIELDS, jes.SCALABLE_OBS_ONLY_FIELDS),
    (plane.RouteState, plane.ROUTE_TRAJECTORY_FIELDS, plane.ROUTE_OBS_ONLY_FIELDS,
     jplane.ROUTE_TRAJECTORY_FIELDS, jplane.ROUTE_OBS_ONLY_FIELDS),
]


@pytest.mark.parametrize("cls,traj,obs,jtraj,jobs", REGISTRIES,
                         ids=[r[0].__name__ for r in REGISTRIES])
def test_registry_is_total_disjoint_and_equal_to_jax(cls, traj, obs, jtraj, jobs):
    fields = set(cls._fields)
    assert not fields - traj - obs, "unclassified: %s" % sorted(fields - traj - obs)
    assert not traj & obs, "classified twice: %s" % sorted(traj & obs)
    assert not (traj | obs) - fields, "stale: %s" % sorted((traj | obs) - fields)
    assert (traj, obs) == (jtraj, jobs)


def test_registries_are_the_prongs_view():
    regs = ni.state_registries()
    assert set(regs) == {"SimState", "ScalableState", "RouteState"}
    for cls, traj, obs, _, _ in REGISTRIES:
        assert regs[cls.__name__] == (traj, obs)


@pytest.mark.parametrize("name", ni.OBS_ENTRY_NAMES)
def test_obs_entry_is_noninterfering(name):
    findings = ni.check_noninterference([name])
    assert findings == [], "\n" + render_text(findings)


def test_every_jax_obs_entry_has_a_counterpart():
    assert set(ni.JAX_OBS_COUNTERPARTS) == set(jni.OBS_ENTRY_NAMES)
    assert len(jni.OBS_ENTRY_NAMES) == 9
    assert set(ni.JAX_OBS_COUNTERPARTS.values()) == set(ni.OBS_ENTRY_NAMES)
    for jax_name, port in ni.JAX_OBS_COUNTERPARTS.items():
        assert ga.JAX_ENTRY_COUNTERPARTS[jax_name] == port


def test_obs_entry_list_is_exhaustive():
    regs = ni.state_registries()
    for ep in ga.DEFAULT_ENTRIES:
        _, args = ep.build()
        has_obs = any(lab.kind == ni.KIND_OBS for lab in ni._labels(tuple(args), regs, "args"))
        assert has_obs == (ep.name in ni.OBS_ENTRY_NAMES), ep.name


def test_seeded_obs_to_trajectory_leak_is_caught():
    """A histogram count folded into a suspicion deadline fails with a
    named, op-located finding."""
    fn, args = BY_NAME["engine-tick-histograms"].build()

    def doctored(state, inputs):
        st, metrics = fn(state, inputs)
        return st._replace(susp_deadline=st.susp_deadline + st.hist[0, 0].to(torch.int32)), \
            metrics

    findings = ni.check_entry("doctored", doctored, args)
    assert any(f.rule == "obs-interference" for f in findings)
    msg = next(f.message for f in findings if f.rule == "obs-interference")
    assert "SimState.hist" in msg
    assert "SimState.susp_deadline" in msg
    assert "op chain:" in msg and "add" in msg


def test_flight_recorder_leak_is_caught():
    fn, args = BY_NAME["engine-tick-flight-recorder"].build()

    def doctored(state, inputs):
        st, metrics = fn(state, inputs)
        return st._replace(iter_pos=st.iter_pos + st.ev_head.to(torch.int32)), metrics

    findings = ni.check_entry("doctored-flight", doctored, args)
    assert any(f.rule == "obs-interference" and "SimState.ev_head" in f.message
               and "SimState.iter_pos" in f.message for f in findings), render_text(findings)


def test_exchange_telemetry_leak_is_caught():
    fn, args = BY_NAME["engine-scalable-tick-exchange-metrics"].build()

    def doctored(state, inputs):
        st, metrics = fn(state, inputs)
        return st._replace(tick_index=st.tick_index + st.exch[0, 0].to(torch.int32)), metrics

    findings = ni.check_entry("doctored-exch", doctored, args)
    assert any(f.rule == "obs-interference" and "ScalableState.exch" in f.message
               and "ScalableState.tick_index" in f.message for f in findings), \
        render_text(findings)


def test_mesh_exchange_telemetry_leak_is_caught():
    fn, args = BY_NAME["engine-scalable-tick-mesh-metrics"].build()

    def doctored(states, inputs):
        states, metrics = fn(states, inputs)
        states[1] = states[1]._replace(rng=states[1].rng + states[0].exch_hist.sum(
            dtype=torch.int32))
        return states, metrics

    findings = ni.check_entry("doctored-mesh", doctored, args)
    assert any(f.rule == "obs-interference" and "ScalableState.exch_hist" in f.message
               and "ScalableState.rng" in f.message for f in findings), render_text(findings)


def test_obs_to_obs_and_obs_to_metrics_flows_are_allowed():
    fn, args = BY_NAME["engine-tick-histograms"].build()

    def doctored(state, inputs):
        st, metrics = fn(state, inputs)
        st = st._replace(hist=st.hist + 1)  # obs -> obs
        last = metrics[-1]
        metrics[-1] = last._replace(  # obs -> metrics (a sink)
            dirty_rows=last.dirty_rows + st.hist[0, 0].to(torch.int32))
        return st, metrics

    findings = ni.check_entry("doctored-ok", doctored, args)
    assert findings == [], "\n" + render_text(findings)


def test_unclassified_state_field_is_a_finding():
    regs = ni.state_registries()
    traj, obs = regs["SimState"]
    doctored = dict(regs)
    doctored["SimState"] = (traj - {"checksum"}, obs)
    with mock.patch.object(ni, "state_registries", lambda: doctored):
        findings = ni.check_noninterference(["engine-tick-histograms"])
    assert any(f.rule == "unclassified-state-field" and "SimState.checksum" in f.message
               and "SIM_TRAJECTORY_FIELDS" in f.message for f in findings), \
        render_text(findings)


def test_entries_for_changed_maps_modules_to_entries():
    assert ni.entries_for_changed(["models/route/plane.py"]) == list(ni.OBS_ENTRY_NAMES)
    assert ni.entries_for_changed(["models/sim/flight.py"]) == [
        "engine-tick-flight-recorder", "fuzz-scan-full"]
    assert ni.entries_for_changed(["fuzz/executor.py"]) == ["fuzz-scan-full"]
    assert ni.entries_for_changed(["obs/recorder.py"]) == []
    assert ni.entries_for_changed(["analysis/dataflow.py"]) == list(ni.OBS_ENTRY_NAMES)
