"""The port's tick-cluster harness and SIGSTOP/SIGCONT path against the JAX
package on the CPU.

- ``SimCluster.suspend``/``resume`` in lockstep with the JAX cluster's: two
  nodes suspended until observers suspect them, then resumed, compared on
  every state and metric field every tick through their refutes, in fast
  and farmhash modes.
- ``TickCluster`` over ``torch-sim`` and ``torch-sim-scalable`` against
  ``jax-sim`` and ``jax-sim-scalable`` (tests/integration/
  test_tick_cluster.py's surface): the same command script gives the same
  snapshots, checksum groups, convergence displays, ``run_command``
  outputs and lookups, including a lookup whose owner died.
- ``create`` builds ``live`` and refuses unknown backends; the CLI's
  ``main`` drives a session.

Tolerance: none.
"""

from __future__ import annotations

import io
import os
import json

import numpy as np
import pytest

from ringpop_tpu.api import tick_cluster as jtc
from ringpop_tpu.models.sim import engine as je
from ringpop_tpu.models.sim.cluster import SimCluster as JaxSimCluster
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.api import tick_cluster as ptc
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim.cluster import SimCluster
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

SUSPECT = 1
# the port keeps the fused pipeline's record cache; the JAX cluster on the
# CPU resolves fused_checksum to "off" and keeps none
_CACHE = ("rec_bytes", "rec_len")


def _assert_same(j, p, label):
    got = convert.state_to_numpy(p.state)
    for f in je.SimState._fields:
        want = getattr(j.state, f)
        if want is None:
            assert got[f] is None or f in _CACHE, (label, f)
            continue
        assert np.array_equal(got[f], np.asarray(want)), "%s: state field %s" % (label, f)


def _assert_metrics(jm, pm, label):
    for f in pe.TickMetrics._fields:
        assert int(np.asarray(getattr(jm, f))) == int(getattr(pm, f)), (label, f)


@pytest.mark.parametrize("mode", ["fast", "farmhash"])
def test_suspend_resume_lockstep_with_jax(mode):
    n, gone = 16, [3, 7]
    j = JaxSimCluster(n=n, params=je.SimParams(n=n, checksum_mode=mode), seed=2)
    p = SimCluster(n=n, params=pe.SimParams(n=n, checksum_mode=mode), seed=2, device="cpu")

    def both(op, *args, label):
        jm, pm = getattr(j, op)(*args), getattr(p, op)(*args)
        _assert_metrics(jm, pm, label)
        _assert_same(j, p, label)
        return pm

    both("bootstrap", label="bootstrap")
    for t in range(40):
        if both("step", label="converge %d" % t).converged:
            break
    both("suspend", gone, label="suspend")
    suspected = False
    for t in range(20):
        both("step", label="suspended %d" % t)
        status = p.state.status.numpy()
        if all((status[:, v] == SUSPECT).any() for v in gone):
            suspected = True
            break
    assert suspected, "the suspended nodes were never suspected"
    refutes = int(both("resume", gone, label="resume").refutes)
    for t in range(30):
        refutes += int(both("step", label="after resume %d" % t).refutes)
    assert refutes > 0  # the resumed nodes re-asserted themselves
    assert len(p.checksum_groups()) == 1 and p.parity_replays == j.parity_replays


def _script(hosts_dead: int, suspend: int):
    return (["t"] * 6 + ["k %d" % hosts_dead] + ["t"] * 8 + ["l %d" % suspend, "t", "t",
            "K %d" % suspend] + ["t"] * 6 + ["K %d" % hosts_dead] + ["t"] * 10
            + ["w key-1", "w 42", "s", "j", "t", "bogus", ""])


@pytest.mark.parametrize("backend,jbackend,n", [
    ("torch-sim", "jax-sim", 8),
    ("torch-sim-scalable", "jax-sim-scalable", 64),
])
def test_tick_cluster_matches_jax(backend, jbackend, n):
    p = ptc.TickCluster.create(backend, n, device="cpu")
    j = jtc.TickCluster.create(jbackend, n)
    assert p.backend.hosts == j.backend.hosts
    p.start()
    j.start()
    with pytest.raises(RuntimeError, match="no snapshot"):
        p.checksum_groups()
    for cmd in _script(3, 5):
        assert p.run_command(cmd) == j.run_command(cmd), cmd
        if cmd == "t":
            assert p._snapshot == j._snapshot
            assert p.checksum_groups() == j.checksum_groups()
            assert p.converged() == j.converged()
    assert p.format_groups() == j.format_groups()
    assert p.tick_until_converged() == j.tick_until_converged()
    for key in ("a", "b", "ringpop", "127.0.0.1:3001", 7):
        assert p.backend.lookup(key) == j.backend.lookup(key)
    assert p.backend.stats_all() == j.backend.stats_all()
    with pytest.raises(EOFError):
        p.run_command("q")
    p.destroy()


def test_scalable_lookup_skips_a_dead_owner():
    p = ptc.TickCluster.create("torch-sim-scalable", 64, device="cpu")
    j = jtc.TickCluster.create("jax-sim-scalable", 64)
    owner = p.backend.lookup("hot-key")
    assert owner == j.backend.lookup("hot-key")
    k = p.backend.hosts.index(owner)
    for c in (p, j):
        c.run_command("k %d" % k)
        c.tick()
    moved = p.backend.lookup("hot-key")
    assert moved == j.backend.lookup("hot-key") and moved not in (None, owner)


def test_sim_lookup_follows_views_and_dead_nodes_raise():
    p = ptc.TickCluster.create("torch-sim", 6, device="cpu")
    j = jtc.TickCluster.create("jax-sim", 6)
    for c in (p, j):
        c.start()
        c.tick_until_converged()
    for node in range(6):
        assert p.backend.lookup("k", node) == j.backend.lookup("k", node)
    p.run_command("k 2")
    with pytest.raises(RuntimeError, match="dead"):
        p.backend.lookup("k", 2)
    assert len(p.backend._ring_cache) <= ptc._RING_CACHE


def test_create_refuses_live_and_unknown_backends():
    # live is a backend of the port now (tests/test_torch_live.py runs it):
    # create builds it without spawning a node, and destroy cleans up
    live = ptc.TickCluster.create("live", 3, base_port=47100)
    assert isinstance(live.backend, ptc.LiveBackend)
    assert live.backend.hosts == ["127.0.0.1:%d" % p for p in (47100, 47101, 47102)]
    live.destroy()
    assert not os.path.exists(live.backend.hosts_file)
    with pytest.raises(ValueError, match="unknown backend"):
        ptc.TickCluster.create("jax-sim", 3)
    with pytest.raises(ValueError, match="caps interactive"):
        ptc.TickCluster.create("torch-sim-scalable", 200_001, device="cpu")


def test_main_drives_a_session(tmp_path):
    out = io.StringIO()
    rc = ptc.main(["--backend", "torch-sim", "-n", "4", "--device", "cpu"],
                  stdin=io.StringIO("t\nt\nt\nw foo\nnope\nq\n"), stdout=out)
    text = out.getvalue()
    assert rc == 0 and "tick-cluster [TorchSimBackend] 4 nodes" in text
    assert "node(s)" in text and "foo -> 127.0.0.1:" in text and "commands:" in text
    path = str(tmp_path / "hosts.json")
    assert ptc.main(["--gen-hosts", path, "-n", "3"], stdout=io.StringIO()) == 0
    with open(path) as f:
        assert json.load(f) == jtc.generate_hosts(str(tmp_path / "j.json"), 3)


def test_interactive_reports_errors_and_keeps_going():
    p = ptc.TickCluster.create("torch-sim", 4, device="cpu")
    p.start()
    out = io.StringIO()
    p.interactive(io.StringIO("k 99\nt\n"), out)
    assert "error:" in out.getvalue() and "node(s)" in out.getvalue()
