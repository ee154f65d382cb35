"""tick-cluster: the operator harness (scripts/tick-cluster.js) on the
port's engines.

Counterpart of ``ringpop_tpu/api/tick_cluster.py``: the same
:class:`TickCluster` command surface and convergence display over two
backends,

- ``torch-sim`` — the full-fidelity engine's :class:`SimCluster` (the
  ``jax-sim`` backend's counterpart), lookups served from the port's
  device ring (``models/ring/device.py``) under the asking node's view;
- ``torch-sim-scalable`` — the O(N·U) engine's :class:`ScalableCluster`
  for 100k-class clusters (``jax-sim-scalable``'s counterpart).

The JAX harness's ``live`` backend spawns the JAX package's node
processes, host code with nothing to port, so :meth:`TickCluster.create`
refuses it by name.  The backends run on the card unless ``device="cpu"``
is passed.  Run it as ``python3 -m ringpop_tpu_torch.api.tick_cluster
--backend torch-sim -n 10`` (``--device cpu`` without a card).

Commands (tick-cluster.js:249-330 key menu): ``tick`` runs one protocol
period on every live node and prints the nodes grouped by membership
checksum (tick-cluster.js:87-114); ``join`` re-joins all, ``kill i`` /
``suspend i`` / ``revive i`` inject faults, ``stats`` dumps protocol
stats, ``lookup key`` names a key's owner.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ringpop_tpu_torch.models.ring import device as ringdev
from ringpop_tpu_torch.ops import farmhash32, u32

# a view-keyed ring cache holds at most this many sorted rings
_RING_CACHE = 8


def generate_hosts(path: str, n: int, base_port: int = 3000, host: str = "127.0.0.1") -> List[str]:
    """Write a hosts.json bootstrap file (scripts/generate-hosts.js:23-58)."""
    hosts = ["%s:%d" % (host, base_port + i) for i in range(n)]
    with open(path, "w") as f:
        json.dump(hosts, f)
    return hosts


def _key_hash(key, device) -> torch.Tensor:
    """FarmHash32 of the key string as a 0-d int32 (uint32) tensor."""
    return torch.tensor(u32.s32(farmhash32.hash32(str(key))), dtype=torch.int32, device=device)


def _cached_ring(cache: dict, in_ring: np.ndarray, build):
    """The (ring, n_points) of a membership view, built once per view: a
    converged cluster shares one ring, and a churny session holds at most
    ``_RING_CACHE`` of them."""
    key = in_ring.tobytes()
    got = cache.get(key)
    if got is None:
        if len(cache) >= _RING_CACHE:
            cache.pop(next(iter(cache)))
        cache[key] = got = build()
    return got


class TorchSimBackend:
    """The command surface over the full-fidelity simulator."""

    def __init__(self, n: int, base_port: int = 3000, device=None, **sim_kw):
        from ringpop_tpu_torch.models.sim.cluster import SimCluster, default_addresses

        self.n = n
        self.sim = SimCluster(
            n=n, addresses=default_addresses(n, base_port=base_port), device=device, **sim_kw
        )
        # engine indices follow the universe's sorted address order
        self.hosts = list(self.sim.universe.addresses)
        self._suspended: set = set()
        self._replica_hashes = None  # device-ring table, built on demand
        self._ring_cache: Dict[bytes, tuple] = {}

    def start(self) -> None:
        self.sim.bootstrap()

    def tick_all(self) -> Dict[str, Optional[int]]:
        self.sim.step()
        cs = self.sim.checksums()
        alive = (self.sim.state.proc_alive & self.sim.state.ready).to("cpu").numpy()
        return {hp: (int(cs[i]) if alive[i] else None) for i, hp in enumerate(self.hosts)}

    def join_all(self) -> None:
        self.sim.bootstrap()

    def stats_all(self) -> Dict[str, Any]:
        alive = self.sim.state.proc_alive.to("cpu").numpy()
        return {hp: {"membership": self.sim.membership_of(i)}
                for i, hp in enumerate(self.hosts) if alive[i]}

    def lookup(self, key, node: int = 0) -> Optional[str]:
        """Key owner per node ``node``'s view, from the device ring (the
        /admin/lookup analog).  Asking a dead node raises."""
        st = self.sim.state
        dev = self.sim.device
        if not bool(st.proc_alive[node]):
            raise RuntimeError("node %s is dead; its ring cannot serve lookups" % self.hosts[node])
        if self._replica_hashes is None:
            self._replica_hashes = u32.from_numpy(
                ringdev.replica_table(self.sim.universe.addresses), dev
            )
        # alive and suspect members stay in the ring
        in_ring = (st.known[node] & (st.status[node] <= 1)).to("cpu").numpy()

        def build():
            mask = torch.as_tensor(in_ring, device=dev)
            return (ringdev.build_ring(self._replica_hashes, mask),
                    ringdev.ring_size(mask, self._replica_hashes.shape[1]))

        ring, n_points = _cached_ring(self._ring_cache, in_ring, build)
        owner = int(ringdev.lookup(ring, n_points, _key_hash(key, dev)))
        return self.sim.universe.addresses[owner] if owner >= 0 else None

    def kill(self, i: int) -> None:
        self._suspended.discard(i)  # kill trumps an earlier suspend
        self.sim.kill([i])

    def suspend(self, i: int) -> None:
        self._suspended.add(i)
        self.sim.suspend([i])

    def revive(self, i: int) -> None:
        if i in self._suspended:
            self._suspended.discard(i)
            self.sim.resume([i])
        else:
            self.sim.revive([i])

    def destroy(self) -> None:
        pass


class TorchScalableBackend:
    """The command surface over the O(N·U) rumor engine, as the JAX
    harness's ``jax-sim-scalable``: node identity is the integer index
    (labels ``node<i>``), ``stats`` reports cluster aggregates, ``suspend``
    is ``kill`` (the rumor engine models death and fresh restart), and
    ``lookup`` serves from the device ring over integer ids.  Per-tick
    snapshots build an N-entry dict, so interactive use is capped at
    :data:`MAX_INTERACTIVE_N` nodes."""

    MAX_INTERACTIVE_N = 200_000

    def __init__(self, n: int, device=None, **storm_kw):
        from ringpop_tpu_torch.models.sim.storm import ScalableCluster

        if n > self.MAX_INTERACTIVE_N:
            raise ValueError(
                "torch-sim-scalable caps interactive use at %d nodes (per-tick host "
                "snapshots); drive ScalableCluster directly for larger runs"
                % self.MAX_INTERACTIVE_N
            )
        self.n = n
        self.cluster = ScalableCluster(n=n, device=device, **storm_kw)
        self.hosts = ["node%d" % i for i in range(n)]
        self._ring_cache: Dict[bytes, tuple] = {}

    def start(self) -> None:
        pass  # the rumor engine starts converged and alive (no join round)

    def tick_all(self) -> Dict[str, Optional[int]]:
        self.cluster.step()
        cs = self.cluster.checksums()
        alive = self.cluster.state.proc_alive.to("cpu").numpy()
        return {hp: (int(cs[i]) if alive[i] else None) for i, hp in enumerate(self.hosts)}

    def join_all(self) -> None:
        pass  # membership is the integer universe, always joined

    def stats_all(self) -> Dict[str, Any]:
        from ringpop_tpu_torch.models.sim import engine_scalable as es

        st = self.cluster.state
        alive = st.proc_alive.to("cpu").numpy()
        truth = st.truth_status.to("cpu").numpy()
        cs = self.cluster.checksums()
        return {
            "cluster": {
                "n": self.n,
                "live_nodes": int(alive.sum()),
                "active_rumors": int(st.r_active.sum()),
                "distinct_checksums": int(np.unique(cs[alive]).size),
                "suspects_in_truth": int((truth == es.SUSPECT).sum()),
                "faulty_in_truth": int((truth == es.FAULTY).sum()),
                "ring_checksum": self.cluster.ring_checksum(),
            }
        }

    def lookup(self, key, node: int = 0) -> Optional[str]:
        from ringpop_tpu_torch.models.sim import engine_scalable as es

        st = self.cluster.state
        dev = self.cluster.device
        in_ring = (st.proc_alive & (st.truth_status <= es.SUSPECT)).to("cpu").numpy()

        def build():
            reps = ringdev.device_replica_hashes(self.n, self.cluster.replica_points, dev)
            ring = ringdev.build_ring(reps, torch.as_tensor(in_ring, device=dev))
            return ring, int(in_ring.sum()) * self.cluster.replica_points

        ring, n_points = _cached_ring(self._ring_cache, in_ring, build)
        if n_points == 0:
            return None
        points = torch.tensor(n_points, dtype=torch.int32, device=dev)
        owner = int(ringdev.lookup(ring, points, _key_hash(key, dev)))
        return self.hosts[owner] if owner >= 0 else None

    def _step_one(self, field: str, i: int) -> None:
        # fault injection rides one protocol period, as in SimCluster
        from ringpop_tpu_torch.models.sim import engine_scalable as es

        inputs = es.ChurnInputs.quiet(self.n, self.cluster.device)
        mask = torch.zeros(self.n, dtype=torch.bool, device=self.cluster.device)
        mask[i] = True
        self.cluster.step(inputs._replace(**{field: mask}))

    def kill(self, i: int) -> None:
        self._step_one("kill", i)

    def suspend(self, i: int) -> None:
        self.kill(i)  # SIGSTOP with state intact is the full engine's domain

    def revive(self, i: int) -> None:
        self._step_one("revive", i)

    def destroy(self) -> None:
        pass


BACKENDS = ("torch-sim", "torch-sim-scalable")


class TickCluster:
    """Backend-agnostic driver with the tick-cluster command surface.
    :meth:`tick` runs one protocol round and caches the host -> checksum
    snapshot; :meth:`checksum_groups`, :meth:`converged` and
    :meth:`format_groups` read that snapshot without advancing."""

    def __init__(self, backend):
        self.backend = backend
        self._snapshot: Optional[Dict[str, Optional[int]]] = None

    @staticmethod
    def create(backend: str, n: int, **kw) -> "TickCluster":
        if backend == "torch-sim":
            return TickCluster(TorchSimBackend(n, **kw))
        if backend == "torch-sim-scalable":
            kw.pop("base_port", None)  # integer-id universe: no ports
            return TickCluster(TorchScalableBackend(n, **kw))
        if backend == "live":
            raise ValueError(
                "the live backend spawns the JAX package's node processes (host code, "
                "not ported): run ringpop_tpu.api.tick_cluster --backend live"
            )
        raise ValueError("unknown backend %r (%s)" % (backend, " | ".join(BACKENDS)))

    def start(self) -> None:
        self.backend.start()

    def tick(self) -> Dict[str, Optional[int]]:
        """One gossip round on every live node; caches and returns the
        host -> checksum snapshot (None = dead or not ready)."""
        self._snapshot = self.backend.tick_all()
        return self._snapshot

    def checksum_groups(self) -> Dict[Any, List[str]]:
        """Hosts grouped by checksum from the last snapshot; key None =
        dead.  A read only: call :meth:`tick` first."""
        if self._snapshot is None:
            raise RuntimeError("no snapshot yet: call tick() before querying groups")
        groups: Dict[Any, List[str]] = {}
        for hp, cs in self._snapshot.items():
            groups.setdefault(cs, []).append(hp)
        return groups

    def format_groups(self, groups: Optional[Dict[Any, List[str]]] = None) -> str:
        """The tick-cluster convergence display (tick-cluster.js:87-114)."""
        if groups is None:
            groups = self.checksum_groups()
        lines = []
        for cs, hosts in sorted(groups.items(), key=lambda kv: (kv[0] is None, str(kv[0]))):
            label = "dead" if cs is None else ("%08x" % (cs & 0xFFFFFFFF))
            lines.append("  %s  %d node(s): %s" % (label, len(hosts), " ".join(hosts)))
        n_groups = sum(1 for cs in groups if cs is not None)
        lines.append("  -> %s" % ("CONVERGED" if n_groups <= 1
                                  else "%d checksum groups" % n_groups))
        return "\n".join(lines)

    def converged(self) -> bool:
        return sum(1 for cs in self.checksum_groups() if cs is not None) <= 1

    def tick_until_converged(self, max_ticks: int = 120) -> int:
        for t in range(max_ticks):
            self.tick()
            if self.converged():
                return t + 1
        raise RuntimeError("no convergence after %d ticks" % max_ticks)

    def run_command(self, line: str) -> str:
        """Scriptable command surface (the key menu, tick-cluster.js:249-330)."""
        parts = line.strip().split()
        if not parts:
            return ""
        cmd, args = parts[0], parts[1:]
        if cmd in ("t", "tick"):
            self.tick()
            return self.format_groups()
        if cmd in ("j", "join"):
            self.backend.join_all()
            return "join sent to all nodes"
        if cmd in ("k", "kill"):
            i = int(args[0])
            self.backend.kill(i)
            return "killed %s" % self.backend.hosts[i]
        if cmd in ("l", "suspend"):
            i = int(args[0])
            self.backend.suspend(i)
            return "suspended %s" % self.backend.hosts[i]
        if cmd in ("K", "revive"):
            i = int(args[0])
            self.backend.revive(i)
            return "revived %s" % self.backend.hosts[i]
        if cmd in ("s", "stats"):
            return json.dumps(self.backend.stats_all(), default=str)[:2000]
        if cmd in ("w", "lookup"):
            return "%s -> %s" % (args[0], self.backend.lookup(args[0]))
        if cmd in ("q", "quit"):
            raise EOFError
        return "commands: tick|join|kill i|suspend i|revive i|stats|lookup key|quit"

    def interactive(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        stdout.write(
            "tick-cluster [%s] %d nodes. Commands: t(ick) j(oin) k(ill) i, "
            "l/suspend i, K/revive i, s(tats), q(uit)\n"
            % (type(self.backend).__name__, len(self.backend.hosts))
        )
        while True:
            stdout.write("> ")
            stdout.flush()
            line = stdin.readline()
            if not line:
                break
            try:
                out = self.run_command(line)
            except EOFError:
                break
            except Exception as e:  # an operator typo must not end the session
                out = "error: %s" % e
            if out:
                stdout.write(out + "\n")

    def destroy(self) -> None:
        self.backend.destroy()


def main(argv=None, stdin=None, stdout=None) -> int:
    p = argparse.ArgumentParser(
        prog="tick-cluster",
        description="ringpop cluster harness (scripts/tick-cluster.js) on the PyTorch engines",
    )
    p.add_argument("-n", type=int, default=5, help="number of nodes")
    p.add_argument("--backend", choices=BACKENDS, default="torch-sim")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--base-port", type=int, default=3000)
    p.add_argument("--gen-hosts", metavar="PATH",
                   help="only write a hosts.json and exit (scripts/generate-hosts.js)")
    args = p.parse_args(argv)
    if args.gen_hosts:
        print(json.dumps(generate_hosts(args.gen_hosts, args.n, args.base_port)), file=stdout)
        return 0
    tc = TickCluster.create(args.backend, args.n, base_port=args.base_port, device=args.device)
    try:
        tc.start()
        tc.interactive(stdin, stdout)
    finally:
        tc.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
