#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the whole run
    python3 chip_smoke.py --quick    # build + kernel checks + card-vs-CPU runs only

It imports ``torch`` and ``ringpop_tpu_torch`` (never JAX) and, in order:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the port's CUDA kernels from ``ringpop_tpu_torch/csrc`` and
   prints the build time;
3. holds each kernel against its plain PyTorch version on the card, on
   random inputs from a seed, for every option combination the engines
   use: every output must be bitwise equal (tolerance: none — all integer
   arithmetic); ``apply_updates`` and ``pb_budget`` at n=1024 and the
   ragged n=1000 and 1001, ``fused_stream`` at B in {1024, 256, 16} rows
   of an N=1024 universe, at B=N=1000, at B=16 x N=1001 (rows not
   16-byte aligned) and on B=64 x N=200 synthetic records of 4, 12 and 16
   words (once with bytes past the lengths set), ``exchange`` at the
   1M-node storm shape (N=1,000,000, W=16), at N=1000 with W in {1, 3, 4,
   8, 16, 40} (16- and 4-byte lanes), W=512 (a 64 KB table in opt-in
   shared memory) and W=2048 (a 256 KB table read from global memory), at
   N=1025 W=4 and N=100,001 / 200,001 (4-word lanes, a ragged last tile),
   and on W=16 views one word (off a 16-byte boundary, N=1000) and one row
   (N=100,001) into their allocations, with and without counts, each
   timed, and at the storm shape with no new bit too (the bit walk idle),
   ``block_loop`` at B=1024 and B=256 rows of the real
   n=1024 checksum strings (I=1843, as their word view, no copy) and at
   the ragged B=1000 with I in {1, 7} and zero trip counts, and
   ``hash32_rows`` (kernel vs plain) on the real n=1024 checksum rows;
   prints each kernel's two times, its plain version's time and its
   bounds (bytes or operations; for the two hash loops also the
   dependency chain of one row): ``device_ms``, the mean CUDA duration of
   the kernel itself from ``torch.profiler``, and ``call_ms`` (``ms`` in
   older notes), CUDA events around the wrapper calls, which is the
   host's cost per call whenever the host issues slower than the card
   runs;
4. runs the n=64 32-tick churn schedule of the full engine on the card
   (kernels) and on the CPU (plain versions) in fast and farmhash modes
   and in the classic unfused configuration (``fused_tick="off"``,
   ``fused_checksum="off"``, "gated" recompute), each with the obs planes
   off and on (flight recorder and histograms), and an n=4096, u=512
   scalable storm (10% churn, 5% packet loss, a
   partition split at tick 5 healed at tick 20) likewise, once more on the
   card with TF32 matmuls allowed and once with ``wavefront``,
   ``histograms`` and ``exchange_metrics=4`` (drained summaries equal
   too): every state and metric field must be
   equal on every tick, bitwise (the scalable ``mean_heard_frac``, a
   float32 mean, too: the ticks where it is not bitwise are counted and
   printed, and must be 0);
   the storm's FarmHash truth checksum on the card must equal the host
   FarmHash32 of the truth checksum string; and an n=4096 routed storm
   (``RoutedStorm``, Q=4096 queries a tick, request traces on at rate 1/2,
   route histograms on, a 30-tick 10% churn storm) in both ring
   implementations, on the card and on the CPU: every RouteState,
   RouteMetrics and ScalableMetrics field equal on every tick, the drained
   request records and histograms too; then checkpoints: the n=4096 storm
   saved on the card at tick 20 (a 2-shard manifest), restored on the CPU
   and on a fresh card cluster and run to tick 40, every state field
   bitwise and every metric by the storm's rule equal to the card's
   uninterrupted run; a farmhash ``SimCluster(n=64)`` (fused tick, flight
   recorder) saved mid-churn in the legacy file and restored on both
   devices, its rebuilt record cache equal to the saved run's and
   ``fused_stream`` launched after the restore, the final state equal to
   the uninterrupted run; and the crash harness
   (``fuzz.crash.run_crash_resume(device="cuda")``) for the three drivers
   at n=64, 12 ticks, seeds 1, 7, 8 and a forced torn manifest at tick 8
   that must resume at 6, with no violation and every damaged newest
   checkpoint skipped; and the shard mesh (``parallel/mesh.py``): the
   n=4096 storm on ``make_mesh(4)`` (four shards on the card, ``exchange``
   on each shard's tile) against the same mesh on the CPU and the card's
   single-device cluster — every state field bitwise, metrics by the
   storm's rule — and again with the all-to-all cap forced to 1 (every
   route on the all-gather fallback), then all of it again with the
   wavefront, the histograms and ``exchange_metrics=4`` on; and
   ``ShardedSim``: the n=64 churn schedule on ``make_mesh(4)`` against the
   same mesh on the CPU and the card's ``SimCluster``, every field of
   every tick, in fast, farmhash and classic (``block_loop`` on each
   shard's rows), with the flight recorder and the histograms off and on;
5. drives the main paths, each with every kernel's launch count reset
   just before and read just after: ``SimCluster(n=1024)`` (bootstrap,
   ``run_until_converged(96, quiet_after=1)``, one warm and one timed
   256-tick ``run``) in fast and farmhash modes, and the 1M-node churn
   storm of ``benchmarks/storm_1m.py`` (``ScalableCluster``, 60 ticks,
   10% killed at tick 2 and revived at tick 30; a cold run, then a warm
   run on a fresh cluster with seed + 1, ring digest before and after);
   requires one ``exchange`` launch per storm tick, every node live at the
   end and the incremental checksums equal to the full recompute; the cold
   run keeps the ``exchange`` operands of ticks 4 and 32, on which the
   kernel is held against its plain version and timed after the path's
   launch counts are read; the checkpointed storms: the 1M storm under
   ``enable_checkpoints(every=20, keep=2)`` killed at tick 45 with its
   forced save torn, restarted cold, ``restore_latest()`` skipping the
   tick-45 checkpoint (``CheckpointTornError``) and resuming at 40, ticks
   40-60 run, every state field bitwise the warm run's (kept as host
   copies), one ``exchange`` launch a tick, every node live, exact
   checksums, the ring digest unchanged, with a ``ckpt`` line of bytes,
   save and restore walls split, ms/tick and host syncs a tick; and the
   routed 100k storm (every=4, a torn manifest at tick 6, resumed at 4)
   bitwise its uninterrupted twin in state, route carry, truth ring and
   ring checksum; and the
   classic configuration ``SimCluster(n=1024, fused_tick="off",
   fused_checksum="off")`` (bootstrap, ``run_until_converged(96,
   quiet_after=1)``, a timed 64-tick ``EventSchedule.churn_window``, one
   warm and one timed 256-tick quiet window), which must launch
   ``block_loop``, converge to one checksum and give node 0 the host
   FarmHash32 of its checksum string; and the routed storm
   (``RoutedStorm`` over ``ScalableParams(n)``, a warm and a timed window
   of sparse churn, random kills each tick revived two ticks later) at
   full width (1M nodes, 2^20 queries a tick, 16 ticks, 32 kills a tick:
   the ring update overflows its caps and falls back from tick 3) and at
   bench.py's 100k (262,144 queries, 8 ticks, 8 kills a tick: every update
   incremental, required), each in both ring implementations, which must
   give equal truth rings and metrics, one ``exchange`` launch a tick and
   routed queries; queries/s, lookups/s (4 a query), ms/tick, host
   syncs/tick and peak memory printed per run; then the ring-maintenance
   A/B at 1M (``ring_kernel.update`` against a ``build_ring`` sort over one
   32-tick sequence of 32 flips a tick, equal rings required); and the
   obs paths: ``SimCluster(n=1024)`` with the flight recorder and the
   histograms on (fast and farmhash; bootstrap, drain, converge, drain, a
   64-tick churn window, drain), stepped beside a planes-off twin whose
   checksums and metrics must be equal on every tick, each window
   dropping nothing and reconciling with its metrics, the histograms
   non-empty, a run log valid; then ms/tick, host reads a tick (equal
   required) and launches a tick, planes on beside planes off; the 1M
   storm's cold schedule with its three planes (one ``exchange`` launch a
   tick, metrics, checksums and host syncs a tick equal to the cold run,
   non-empty drains, peak memory); the routed 1M storm with route
   histograms (rings and metrics equal to its planes-off run); and the
   tick-cluster harness (``torch-sim`` at n=1024, ``torch-sim-scalable``
   at n=100,000, lookups against a numpy host ring); the host obs layer
   (``obs_host_path``): the n=1024 farmhash planes-on ``SimCluster``
   wrapped by ``obs.perf.wrap_cluster`` and tapped by a ``SimTracerHost``
   beside an unwrapped, untapped twin — a 16-tick churn window through
   ``timed_window``, the same window profiled (host reads a tick equal),
   an 8-tick window through ``obs.xprof.capture``, state bitwise the
   twin's and every drain covered by the tracer's records after each
   window, the merged host timeline valid, the ``perf.phase`` and
   ``xprof.capture`` rows schema-valid — the resolution gauges of that
   cluster and an n=4096 ``ScalableCluster``, and an n=4096 routed storm
   with route histograms over 4 windows of 4 ticks feeding the SLO plane
   (schema-valid ``slo.window`` rows, Prometheus ``_count`` lines equal
   to the drained totals); the 1M storm on a
   4-shard mesh (``ShardedStorm``, all four shards on ``cuda:0``, and on
   ``cuda:0..3`` too where there are four cards) beside its single-device
   twin: a cold run with ``exchange_metrics=4`` checkpointed every 20
   ticks and a timed warm run, each launching ``exchange`` 4 times a tick,
   its final state bitwise the twin's, every node live, ring digest
   0x29292e35, the drained exchange totals equal to the twin's, the
   all-to-all bytes equal to the traffic model's per route; the tick-20
   checkpoint (four shard files) resumed on 1 and 2 shards and run to 60
   bitwise; launches and host reads a tick of its fail window, mesh and
   twin; after the counts are read, ``exchange`` on two of the warm run's
   own shard tiles ([250000, 16]) held against its plain version and
   timed; ``ShardedSim(1024, make_mesh(4))`` fast and farmhash beside its
   twin (converged in 7 ticks, a timed 256-tick window, 0 replays, the
   state bitwise the twin's; launches and host reads a tick of a churn
   window; round-robin over the cards too where two or more are visible),
   the classic n=1024 mesh and ``ShardedSim(8192, make_mesh(4))`` fast
   beside its twin; after the counts are read, each of the four kernels
   on one shard's own [256, 1024] tile kept from that path
   (``apply_updates`` at ``lo`` = 256) held against its plain version and
   timed with the L2 flushed; the obs planes on both meshes:
   ``ShardedSim(1024, make_mesh(4))`` with the flight recorder and the
   histograms (fast and farmhash; bootstrap, converge, a 16-tick churn
   window) stepped beside the planes-on twin, the planes-off mesh and a
   planes-off twin — metrics equal every tick, after each window every
   field of the joined state (the planes' included) bitwise the twin's,
   the decoded events equal to the twin's drain, nothing dropped, the
   histogram summaries equal — then launches, device ms, ms and host
   reads a tick (equal on and off) of a churn window, what the planes add
   on the mesh beside what they add on the twin, state and window GiB;
   the planes-on
   1M storm on 4 shards beside the twin of the 1M obs path (4 ``exchange``
   launches a tick; ``first_heard``, ``hist`` and the wavefront summary of
   the joined state bitwise the twin's; ms/tick and peak GiB of both);
   ``fused_checksum.membership_checksums`` on 1,024 views at n=1024
   (``fused_stream``) against its plain version and against
   ``hash32_rows`` of each of the four ``membership_rows`` encoders
   (``block_loop``), each timed; each path's seconds are printed;
6. the batch axis (``torch.func.vmap``): each kernel's batching rule at
   B in {1, 4} over phase 3's shapes (``apply_updates`` / ``pb_budget``
   at n=1024 and 1001 with per-cluster stamps, ``fused_stream`` at 256 x
   N=1024 and 16 x N=1001 rows, ``block_loop`` at 256 real checksum rows
   and 1000 x I=7, ``exchange`` at N=100,001, W=16 with and without
   counts): one launch per batched call, bitwise equal to the B
   single-cluster launches and the plain version, the batched call timed;
   ``BatchedSimClusters(b=4, n=64)`` with the flight recorder on the churn
   schedule in fast, farmhash and classic: card == CPU on every state and
   metric field of every tick, each cluster == the card's solo
   ``SimCluster(gate_phases=False)`` with seed + i, the drained streams
   equal; the fuzz smoke sweeps (full n=8 20 ticks, scalable n=32 24
   ticks, 8 seeds, loss 0 and 0.1) card == CPU with no violation, the
   scalable one again through the ``exchange`` kernel; then, as main
   paths, ``BatchedSimClusters(b, n=1024)`` with the headline params (fast
   at B in {1, 8, 32}, farmhash at B in {1, 8}: bootstrap, converge, a
   timed 64-tick churn window and a timed 64-tick quiet window, a profiled
   16-tick churn window, then one tick whose batching-rule calls — the
   real ``[B, ...]`` operands and the kernels' results — are kept and held
   bitwise against the plain versions on the same operands; converged,
   one checksum group per cluster, node 0 of cluster 0 == host FarmHash32
   in farmhash mode) beside the gated single-cluster headline above, and
   the 640 + 384-scenario wide fuzz sweep (zero violations; scenarios/s,
   launches per batched tick from 16- and 32-tick profiled runs; the full
   sweep's first bucket, ~216 instances a launch, equal to the same bucket
   run with the plain versions on the card);
Profiled windows are counted from the profiler's raw records (the first
one also through ``key_averages``, which must agree).

   Then the port's parity oracle on the card: ``parity.check``'s lockstep
   loop (the port's farmhash ``SimCluster`` on the card against the port's
   ``OracleCluster``, one host ``Membership`` a node hashed with the C++
   FarmHash, on ``scripts/parity_check.py``'s schedule) at n=256 fused, 40
   ticks (``apply_updates``, ``pb_budget``, ``fused_stream``) and n=128
   classic, 30 ticks (``block_loop``): every checksum of every tick equal,
   converged at the end, the oracle's and the engine's walls printed apart
   (cut from n=1024 for time: the oracle's host time grows as n^2); and
   the live node (``live_path``): five node processes of the port through
   ``TickCluster.create("live", 5)`` converge, one is killed, the four
   survivors agree again and name the same owner for 100 keys.

   Last among the main paths, the static analysis (``analysis_path``):
   the nine prongs of ``ringpop_tpu_torch.analysis`` on the CPU (any
   finding fails the run), then the host-read audit on the card, each
   path under the op recorder,
   ``torch.cuda.set_sync_debug_mode("error")`` (any sync raises) and the
   aliasing audit (no kernel result aliases an operand): the
   straight-line n=1024 farmhash tick, ``BatchedSimClusters(4,
   1024)``'s tick, ``hash32_rows`` of 1,024 real checksum rows and one
   ``exchange`` at [1M, 16]; the measured peak of the straight-line tick
   and of a warm 1M storm tick against the ``scale`` polynomial; the
   retrace probes on the card; and the gated n=1024 fast churn tick, whose
   ``_local_scalar_dense`` reads must be equal on the card, on the CPU
   and in ``tick_profile``'s count; one ``analysis`` line;

7. prints the ``kernels`` JSON line (each kernel with its batched
   times), the card line, and last ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Without a CUDA device, or run from
a directory without the package, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N_HEAD = 1024
TICKS = 256
N_STORM = 1_000_000
STORM_TICKS = 60
N_MID = 4096
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT32_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (the fp32 peak)
# cycles on the carry path of one farmhashmk mixing round, read off the
# SASS of csrc/block_loop.cu (sm_90a): g -> IADD (g + b), LOP3 (^), SHF
# (rotate), IMAD (*5 + a), VIADD (+MAGIC), IADD3 (d + MAGIC + ng), IMAD
# (nf), IMAD.IADD (ng + nf) -> g: 8 dependent integer ops of 4 cycles each.
# The chain bound of a row of R rounds is R * ROUND_CYCLES at the card's
# top SM clock.
ROUND_CYCLES = 32
CHURN_TICKS = 64


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean ms per call of ``fn`` from CUDA events around ``reps`` calls:
    for a kernel wrapper this is its ``call_ms``, which is the host's
    cost per call whenever the host issues slower than the card runs."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


DEVICE_MS_METHOD = ("torch.profiler CUDA activity (CUPTI kernel records): mean duration of "
                    "the kernel's own launches seen over as many wrapper calls as call_ms "
                    "times")


# written before each profiled call when a kernel is timed with a cold L2:
# 256 MiB, five times the H100's 50 MB L2, so none of the operands of the
# call before stays there
_L2_SCRATCH = []


def _evict_l2() -> None:
    if not _L2_SCRATCH:
        _L2_SCRATCH.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    _L2_SCRATCH[0].fill_(1)


def _device_ms(fn, reps: int, symbol: str, evict: bool = False):
    """Mean CUDA duration (ms) of the kernels whose name holds ``symbol``,
    over ``reps`` calls of ``fn`` under ``torch.profiler``: the kernel's
    time on the card, apart from the host's cost to call it.  ``evict``:
    flush the L2 before each call, so operands that would fit there are
    read from HBM as on the path.  Returns it with the number of launches
    the profiler reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler does not deliver every kernel record (it has shown 7 of
    # 20, mostly the first of a window missing, once none of 50, and twice
    # none in three windows of 20): each window opens with a flush of the
    # L2 that no symbol matches, the mean is over the launches it saw,
    # their count is kept, a window in which it saw none is profiled again,
    # and after three such windows the calls are timed with CUDA events
    # instead (:func:`_events_device_ms`)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _evict_l2()
            torch.cuda.synchronize()
            for _ in range(reps):
                if evict:
                    _evict_l2()
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and symbol in e.key]
        count = sum(e.count for e in rows)
        us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                 for e in rows)
        if count and us > 0:
            return us / count / 1e3, count
    print("%s: profiler saw no launch in 3 x %d calls; timed with CUDA events" % (symbol, reps),
          flush=True)
    return _events_device_ms(fn, reps, evict), 0


EVENTS_MS_METHOD = ("CUDA events around each wrapper call, all calls queued behind a spin "
                    "kernel so that the host's cost to issue them falls outside the pairs, the "
                    "L2 flushed outside the pairs where it is flushed: the mean over the calls "
                    "(taken where the profiler delivered no kernel record)")


def _events_device_ms(fn, reps: int, evict: bool) -> float:
    """Mean ms of one call of ``fn`` on the card, between two CUDA events
    recorded on its stream right before and after it.  A spin kernel
    holds the stream while the host queues every call, so the pairs time
    the calls' kernels back to back and not the host's issue; the spin is
    doubled until it outlasts the queueing."""
    spin_s = 0.05
    for _ in range(6):
        torch.cuda.synchronize()
        # cycles at the H100's highest SM clock (1.98 GHz): at a lower
        # clock the spin lasts longer
        torch.cuda._sleep(int(spin_s * 1.98e9))
        t0 = time.perf_counter()
        pairs = []
        for _ in range(reps):
            if evict:
                _evict_l2()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        queued_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if queued_s < spin_s:
            return sum(a.elapsed_time(b) for a, b in pairs) / reps
        spin_s *= 2
    raise AssertionError("queueing %d calls outlasted a %.2f s spin" % (reps, spin_s / 2))


def _times(fn, reps: int, symbol: str, warm: int = 1, evict: bool = False) -> dict:
    """``call_ms`` (CUDA events around the wrapper calls) and
    ``device_ms`` (the kernel alone, from the profiler; ``evict``: with a
    cold L2) over ``reps`` calls each; ``ms`` repeats ``call_ms``, the
    name older notes use."""
    call = _time_ms(fn, reps, warm)
    device, seen = _device_ms(fn, reps, symbol, evict)
    print("%s: device %.4f ms (%d of %d launches seen), call %.4f ms"
          % (symbol, device, seen, reps, call), flush=True)
    return dict(ms=call, call_ms=call, device_ms=device, device_launches_seen=seen,
                device_ms_method=EVENTS_MS_METHOD if seen == 0 else DEVICE_MS_METHOD)


def _brief(r: dict) -> dict:
    """The numbers of one timed operand set, for the kernels line."""
    keep = ("device_ms", "call_ms", "share_of_bound", "new_bits_per_word")
    out = dict({k: r[k] for k in keep}, bound_ms=r["bound"][0], **_events_method(r))
    if "device_ms_warm_l2" in r:
        out["device_ms_warm_l2"] = r["device_ms_warm_l2"]
    return out


def _events_method(r: dict) -> dict:
    """``device_ms_method`` for a nested entry of the kernels line, named
    only where its ``device_ms`` came from CUDA events and not from the
    line's own method."""
    return ({"device_ms_method": EVENTS_MS_METHOD}
            if r.get("device_ms_method") == EVENTS_MS_METHOD else {})


def _leaves(x):
    if x is None:
        return []
    if isinstance(x, tuple):
        return [y for v in x for y in _leaves(v)]
    return [x]


def _same(a, b, what: str) -> int:
    """Require bitwise equality; returns the measured max |a - b| (0)."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        raise AssertionError("%s: %d vs %d outputs" % (what, len(la), len(lb)))
    err = 0
    for i, (x, y) in enumerate(zip(la, lb)):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError("%s: output %d has another dtype or shape" % (what, i))
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
        if not bool((x == y).all()):
            raise AssertionError("%s: output %d differs from the plain version" % (what, i))
    return err


def _nbytes(xs) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(xs))


def _bound(bytes_moved: int, ops: float):
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _chain_ms(rounds: int) -> float:
    """The dependency-chain bound of a row of ``rounds`` mixing rounds."""
    return rounds * ROUND_CYCLES / _sm_clock_hz() * 1e3


# ---------------------------------------------------------------------------
# kernel inputs (numpy, from a seed)


def _apply_inputs(n, seed, dev):
    import numpy as np

    from ringpop_tpu_torch.ops import fused_apply as fa
    from ringpop_tpu_torch.ops import toolkit

    rng = np.random.default_rng(seed)

    def b(p):
        return torch.as_tensor(rng.random((n, n)) < p, device=dev)

    def i(lo, hi):
        return torch.as_tensor(rng.integers(lo, hi, (n, n), dtype=np.int32), device=dev)

    st = fa.ApplyState(b(0.8), i(0, 4), i(0, 50), b(0.3), i(0, 4), i(0, 50),
                       i(-1, n), i(0, 50), i(0, 20), i(-1, 60))
    upd = (b(0.4), i(0, 4), i(0, 50), i(0, n), i(0, 50))
    union = torch.as_tensor(
        rng.integers(-2**31, 2**31, (n, toolkit.packed_width(n)), dtype=np.int64).astype(np.int32),
        device=dev,
    )
    now = torch.tensor(37, dtype=torch.int32, device=dev)
    deadline = torch.tensor(43, dtype=torch.int32, device=dev)
    return st, upd, union, now, deadline


def _budget_inputs(n, seed, dev):
    import numpy as np

    rng = np.random.default_rng(seed)
    active = torch.as_tensor(rng.random((n, n)) < 0.5, device=dev)
    pb = torch.as_tensor(rng.integers(0, 40, (n, n), dtype=np.int32), device=dev)
    nbump = torch.as_tensor(rng.integers(0, 4, n, dtype=np.int32), device=dev)
    max_pb = torch.as_tensor(rng.integers(15, 50, n, dtype=np.int32), device=dev)
    hits = torch.as_tensor(rng.integers(0, 2, (n, n), dtype=np.int32), device=dev)
    return active, pb, nbump, max_pb, hits


def _stream_inputs(B, N, seed, dev):
    """Realistic record words: B random views of an N-node universe
    encoded by the port's record encoder, with the carries fused_hash_rows
    feeds."""
    import numpy as np

    from ringpop_tpu_torch.models.sim.cluster import default_addresses
    from ringpop_tpu_torch.ops import checksum_encode as ce
    from ringpop_tpu_torch.ops import fused_checksum as fc

    rng = np.random.default_rng(seed)
    uni = ce.Universe.from_addresses(default_addresses(N))
    present = torch.as_tensor(rng.random((B, N)) < 0.9, device=dev)
    status = torch.as_tensor(rng.integers(0, 4, (B, N), dtype=np.int32), device=dev)
    inc = torch.as_tensor(rng.integers(1, 10**13, (B, N)), device=dev)
    rec_b, rec_l = fc.member_records(uni, present, status, inc, 14)
    words = fc.pack_record_words(rec_b)
    total = (rec_l.sum(dim=1, dtype=torch.int32) - 1).clamp(min=0)
    tb = torch.where(total > 24, torch.div(total - 1, 20, rounding_mode="floor"), 0).to(torch.int32)
    h0, g0, f0 = (
        torch.as_tensor(rng.integers(-2**31, 2**31, B, dtype=np.int64).astype(np.int32), device=dev)
        for _ in range(3)
    )
    return h0, g0, f0, words.contiguous(), rec_l.contiguous(), tb


def _synthetic_stream_inputs(B, N, rw, seed, dev, padded=True):
    """Random records of rw words (lengths in [0, 4 * rw], non-zero bytes,
    zero past each length when ``padded``) with the real total_blocks
    rule: the record widths no default address universe gives."""
    import numpy as np

    from ringpop_tpu_torch.ops import u32

    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 4 * rw + 1, (B, N)).astype(np.int32)
    raw = rng.integers(1, 256, (B, N, 4 * rw), dtype=np.uint8)
    if padded:
        raw[np.arange(4 * rw)[None, None, :] >= lens[:, :, None]] = 0
    words = raw.view("<u4").reshape(B, N, rw)
    total = np.maximum(lens.sum(axis=1) - 1, 0)
    tb = np.where(total > 24, (total - 1) // 20, 0).astype(np.int32)
    carries = (u32.from_numpy(rng.integers(0, 2**32, B, dtype=np.uint32), dev) for _ in range(3))
    return (*carries, u32.from_numpy(words, dev), torch.as_tensor(lens, device=dev),
            torch.as_tensor(tb, device=dev))


def _checksum_rows(n, rows, seed, dev):
    """The real checksum strings of ``rows`` random views of an n-node
    universe (nearly every member known, every status, 13-digit
    incarnations): ``(buf [rows, W] uint8, lens [rows] int32)``."""
    import numpy as np

    from ringpop_tpu_torch.models.sim.cluster import default_addresses
    from ringpop_tpu_torch.ops import checksum_encode as ce

    rng = np.random.default_rng(seed)
    uni = ce.Universe.from_addresses(default_addresses(n))
    present = torch.as_tensor(rng.random((rows, n)) < 0.97, device=dev)
    status = torch.as_tensor(rng.integers(0, 4, (rows, n), dtype=np.int32), device=dev)
    inc = torch.as_tensor(rng.integers(10**12, 2 * 10**12, (rows, n)), device=dev)
    return ce.membership_rows(uni, present, status, inc, max_digits=14)


def _block_inputs(rows, seed, dev):
    """``block_loop``'s operands as ``hash32_rows`` builds them from the
    real n=1024 checksum rows: the [rows, I, 5] word view (rows 9217 words
    apart, no copy) and the per-row trip counts, with seeded carries."""
    import numpy as np

    from ringpop_tpu_torch.ops import farmhash as fh

    mat, lens = _checksum_rows(N_HEAD, rows, seed, dev)
    words = fh.pack_words(mat)
    n_iter = (mat.shape[1] - 1) // 20
    blocks = words[:, : 5 * n_iter].reshape(rows, n_iter, 5)
    iters = torch.div(lens - 1, 20, rounding_mode="floor").to(torch.int32)
    rng = np.random.default_rng(seed)
    h0, g0, f0 = (
        torch.as_tensor(rng.integers(-2**31, 2**31, rows, dtype=np.int64).astype(np.int32),
                        device=dev)
        for _ in range(3)
    )
    return h0, g0, f0, blocks, iters


def check_block_loop(dev) -> dict:
    """Phase 3, ``block_loop``: the kernel against its plain version at the
    main path's shapes (B=1024 for init and full recomputes, B=256 for a
    gated chunk) and ragged ones; ``hash32_rows`` kernel vs plain on the
    real rows; times and bounds at B=1024."""
    import numpy as np

    from ringpop_tpu_torch.ops import block_loop as bl
    from ringpop_tpu_torch.ops import farmhash as fh
    from ringpop_tpu_torch.ops import u32

    err = 0
    cases = {}
    for rows in (N_HEAD, 256):
        args = _block_inputs(rows, 11 + rows, dev)
        err = max(err, _same(bl.block_loop(*args), bl.block_loop_plain(*args),
                             "block_loop B=%d I=%d" % (rows, args[3].shape[1])))
        cases[rows] = args
    rng = np.random.default_rng(5)
    for n_iter in (1, 7):
        B = 1000
        blocks = u32.from_numpy(rng.integers(0, 2**32, (B, n_iter, 5), dtype=np.uint32), dev)
        iters = rng.integers(0, n_iter + 1, B).astype(np.int32)
        iters[::3] = 0
        carries = [u32.from_numpy(rng.integers(0, 2**32, B, dtype=np.uint32), dev)
                   for _ in range(3)]
        args = (*carries, blocks, torch.as_tensor(iters, device=dev))
        err = max(err, _same(bl.block_loop(*args), bl.block_loop_plain(*args),
                             "block_loop B=1000 I=%d" % n_iter))
    mat, lens = _checksum_rows(N_HEAD, N_HEAD, 17, dev)
    got = fh.hash32_rows(mat, lens, impl="kernel")
    err = max(err, _same(got, fh.hash32_rows(mat, lens, impl="plain"), "hash32_rows n=1024"))
    print("block_loop bitwise equal to its plain version at B=1024 and 256 (I=%d, real "
          "checksum rows, strided view) and B=1000 I in (1, 7); hash32_rows kernel == plain "
          "on %d real rows of %d bytes" % (cases[N_HEAD][3].shape[1], N_HEAD,
                                           int(lens.max())), flush=True)
    out = {}
    for rows, args in cases.items():
        iters = args[4].clamp(0, args[3].shape[1])
        rounds = int(iters.sum())
        # each round's 20 bytes read once, the carries and counts read and
        # the carries written once; ~31 integer ops a round
        r = dict(
            _times(lambda: bl.block_loop(*args), 20, "block_loop_kernel"),
            bound=_bound(20 * rounds + 7 * 4 * rows, 31.0 * rounds),
            chain_bound_ms=_chain_ms(int(iters.max())),
            rounds_max=int(iters.max()),
        )
        r["plain_ms"] = _time_ms(lambda: bl.block_loop_plain(*args), 1, warm=0)
        print("block_loop B=%d: device %.4f ms, call %.4f ms, plain %.4f ms, bound %.4f ms (%s), "
              "chain bound %.4f ms (%d rounds x %d cycles)"
              % (rows, r["device_ms"], r["call_ms"], r["plain_ms"], r["bound"][0], r["bound"][1],
                 r["chain_bound_ms"], r["rounds_max"], ROUND_CYCLES), flush=True)
        out[rows] = r
    report = out[N_HEAD]
    report["max_abs_err"] = err
    report["b256"] = out[256]
    return report


def check_kernels(dev):
    """Phase 3: every kernel against its plain version on the card."""

    from ringpop_tpu_torch.ops import fused_apply as fa
    from ringpop_tpu_torch.ops import fused_piggyback as fp
    from ringpop_tpu_torch.ops import stream_hash as sh

    report = {}
    err = {"apply_updates": 0, "pb_budget": 0, "fused_stream": 0}
    # (union, want_masks, want_count, want_refute): the engine's sites
    # with the dense masks off (fast mode) and on (farmhash mode, and any
    # mode with an obs plane on: the same site shapes with want_masks)
    apply_combos = [(u, m, c, r) for m in (False, True)
                    for (u, c, r) in ((True, False, True), (True, True, False), (False, True, False))]
    # (hits, want_content): sender select, receiver bump / ping-req leg 3,
    # ping-req leg 1
    budget_combos = [(False, True), (True, True), (False, False)]
    # n=1000 and 1001 are ragged widths (a partial union word; n % 4 != 0)
    for n in (N_HEAD, 1000, 1001):
        st, upd, union, now, deadline = _apply_inputs(n, 1, dev)
        for (u, m, c, r) in apply_combos:
            kw = dict(want_masks=m, want_count=c, want_refute=r)
            args = (st, *upd, now, deadline, union if u else None)
            got = fa.apply_updates(*args, **kw)
            want = fa.apply_updates_plain(*args, **kw)
            torch.cuda.synchronize()
            err["apply_updates"] = max(err["apply_updates"], _same(
                tuple(got), tuple(want), "apply_updates n=%d %r" % (n, (u, m, c, r))))
        active, pb, nbump, max_pb, hits = _budget_inputs(n, 2, dev)
        for (h, c) in budget_combos:
            args = (active, pb, nbump, max_pb, hits if h else None)
            got = fp.pb_budget(*args, want_content=c)
            want = fp.pb_budget_plain(*args, want_content=c)
            torch.cuda.synchronize()
            err["pb_budget"] = max(err["pb_budget"], _same(
                tuple(got), tuple(want), "pb_budget n=%d %r" % (n, (h, c))))
        print("apply_updates, pb_budget bitwise equal to their plain versions at n=%d" % n,
              flush=True)

        if n != N_HEAD:
            continue
        # times at the main path's shapes: the farmhash receive site, the
        # receiver-bump site
        a_args = (st, *upd, now, deadline, union)
        a_kw = dict(want_masks=True, want_count=False, want_refute=True)
        a_out = fa.apply_updates(*a_args, **a_kw)
        a_bytes = _nbytes(tuple(st) + upd + (union,)) + _nbytes(tuple(a_out))
        report["apply_updates"] = dict(
            _times(lambda: fa.apply_updates(*a_args, **a_kw), 50, "apply_updates_kernel"),
            plain_ms=_time_ms(lambda: fa.apply_updates_plain(*a_args, **a_kw), 10),
            bound=_bound(a_bytes, 40.0 * n * n),
        )
        b_args = (active, pb, nbump, max_pb, hits)
        b_out = fp.pb_budget(*b_args)
        b_bytes = _nbytes(b_args) + _nbytes(tuple(b_out))
        report["pb_budget"] = dict(
            _times(lambda: fp.pb_budget(*b_args), 50, "pb_budget_kernel"),
            plain_ms=_time_ms(lambda: fp.pb_budget_plain(*b_args), 10),
            bound=_bound(b_bytes, 8.0 * n * n),
        )
    # fused_stream: the full-cluster row hash (B = N = 1024), partial
    # dirty batches (B = 256, 16), a ragged universe (B = N = 1000) and
    # rows that are not 16-byte aligned (N * RW % 4 != 0: the kernel's
    # 4-byte loads)
    for B, N in ((N_HEAD, N_HEAD), (256, N_HEAD), (16, N_HEAD), (1000, 1000), (16, 1001)):
        sargs = _stream_inputs(B, N, 3 + B, dev)
        t0 = time.perf_counter()
        want = sh.fused_stream_plain(*sargs)
        torch.cuda.synchronize()
        stream_plain_s = time.perf_counter() - t0
        got = sh.fused_stream(*sargs)
        torch.cuda.synchronize()
        err["fused_stream"] = max(err["fused_stream"], _same(
            got, want, "fused_stream B=%d N=%d" % (B, N)))
        if N != N_HEAD:
            continue
        if B != N_HEAD:
            # a partial dirty batch: the card mostly empty, each row's chain
            print("fused_stream B=%d N=%d: chain bound %.4f ms" % (
                B, N, _chain_ms(int(sargs[5].max()))), flush=True)
            _times(lambda: sh.fused_stream(*sargs), 10, "fused_stream_kernel")
            continue
        s_bytes = _nbytes(sargs) + _nbytes(got)
        # per member step: ~10 ops per residual word appended + a
        # ~40-op mixing round per 20-byte block mixed
        s_ops = 10.0 * B * N * (sargs[3].shape[2] + 5) + 40.0 * float(sargs[5].sum())
        report["fused_stream"] = dict(
            _times(lambda: sh.fused_stream(*sargs), 10, "fused_stream_kernel"),
            plain_ms=stream_plain_s * 1e3,
            bound=_bound(s_bytes, s_ops),
            # one sequential chain per row: its block rounds
            chain_bound_ms=_chain_ms(int(sargs[5].max())),
        )
    # every other record width the kernel takes at its extremes, on
    # synthetic records; unpadded bytes past rec_len once
    for rw, padded in ((4, True), (12, True), (16, True), (16, False)):
        args = _synthetic_stream_inputs(64, 200, rw, 29 + rw, dev, padded)
        err["fused_stream"] = max(err["fused_stream"], _same(
            sh.fused_stream(*args), sh.fused_stream_plain(*args),
            "fused_stream RW=%d padded=%s" % (rw, padded)))
    print("fused_stream bitwise equal to its plain version at B in (1024, 256, 16) x N=1024, "
          "B=N=1000 and B=16 x N=1001 (RW=%d), and B=64 x N=200 synthetic records at RW in "
          "(4, 12, 16)" % sargs[3].shape[2], flush=True)
    for name, r in report.items():
        print("%s: device %.4f ms, call %.4f ms, plain %.4f ms, bound %.4f ms (%s)"
              % (name, r["device_ms"], r["call_ms"], r["plain_ms"], r["bound"][0],
                 r["bound"][1]), flush=True)
    for name, e in err.items():
        report[name]["max_abs_err"] = e
    return report


# ---------------------------------------------------------------------------
# n=64 churn run: card (kernels) vs CPU (plain versions)


def _churn_schedule(n, ticks):
    import numpy as np

    from ringpop_tpu_torch.models.sim.cluster import EventSchedule

    sched = EventSchedule(ticks=ticks, n=n)
    sched.kill[3, 5] = True
    sched.revive[ticks // 2, 5] = True
    sched.kill[7, 11] = True
    sched.leave = np.zeros((ticks, n), bool)
    sched.leave[5, 9] = True
    sched.join[3 * ticks // 4, 9] = True
    return sched


def check_e2e(n=64, ticks=32):
    """Phase 4, full engine: the churn run on the card equals the CPU on
    every state and metric field of every tick, in fast, farmhash and
    classic, with the obs planes off and on (flight recorder and
    histograms: the event buffers, heads, drops, first_heard and hist)."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim.cluster import SimCluster, _tick_at

    for mode, planes in ((m, o) for o in (False, True) for m in ("fast", "farmhash", "classic")):
        p = engine.SimParams(n=n, checksum_mode="fast" if mode == "fast" else "farmhash",
                             suspicion_ticks=6, flight_recorder=planes, histograms=planes)
        if mode == "classic":
            p = p._replace(fused_tick="off", fused_checksum="off")
        sims = [SimCluster(n=n, params=p, seed=1, device=d) for d in ("cuda", "cpu")]
        assert sims[0].params.hash_impl == "kernel" and sims[1].params.hash_impl == "plain"
        if mode == "classic":
            assert sims[0].params.parity_recompute == "gated"
        else:
            assert sims[0].params.fused_tick == "kernel" and sims[1].params.fused_tick == "plain"
        sched = _churn_schedule(n, ticks)
        ins = [sched.as_inputs(s.device) for s in sims]
        ms = [s.bootstrap() for s in sims]
        for t in range(ticks + 1):
            for f in engine.TickMetrics._fields:
                if not (getattr(ms[0], f) == getattr(ms[1], f)).all():
                    raise AssertionError("n=%d %s planes=%s tick %d: metric %s differs"
                                         % (n, mode, planes, t, f))
            a, b = (convert.state_to_numpy(s.state) for s in sims)
            for f in engine.SimState._fields:
                if (a[f] is None) != (b[f] is None) or (
                    a[f] is not None and not (a[f] == b[f]).all()
                ):
                    raise AssertionError("n=%d %s planes=%s tick %d: state %s differs"
                                         % (n, mode, planes, t, f))
            if t < ticks:
                ms = [s.step(_tick_at(i, t)) for s, i in zip(sims, ins)]
        obs = ""
        if planes:
            obs = " (obs planes on: %d events, %d dropped, %d histogram observations)" % (
                int(sims[0].state.ev_head), sims[0].event_drops(),
                int(convert.state_to_numpy(sims[0].state)["hist"].astype("int64").sum()))
        print("n=%d %s: %d ticks, card == cpu on every state and metric field%s"
              % (n, mode, ticks + 1, obs), flush=True)


# ---------------------------------------------------------------------------
# the scalable engine's exchange kernel


def _exchange_inputs(n, w, seed, dev):
    """Seeded masks: heard at bit density 1/2, pulled and pushed rows at
    1/8 (a storm tick's partner rows add a few bits per word), and a
    full-range delta table."""
    import numpy as np

    from ringpop_tpu_torch.ops import u32

    rng = np.random.default_rng(seed)

    def words(k):
        out = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
        for _ in range(k - 1):
            out &= rng.integers(0, 2**32, (n, w), dtype=np.uint32)
        return u32.from_numpy(out, dev)

    delta = u32.from_numpy(rng.integers(0, 2**32, w * 32, dtype=np.uint32), dev)
    return words(1), words(3), words(3), delta


def _exchange_plan(ex, args):
    """The launch plan the wrapper takes for ``args`` (None for a port
    without ``exchange_plan``, such as an older tree run by this script)."""
    if not hasattr(ex, "exchange_plan"):
        return None
    n, w = args[0].shape
    return ex.exchange_plan(n, w, ex._aligned(*args[:3]), ex._sm_count(args[0].device.index))


def _exchange_view(t, offset_words):
    """A copy of ``t`` that starts ``offset_words`` words into its
    allocation: 1 puts it off a 16-byte boundary, W is ``x[1:]`` of an
    [N + 1, W] tensor."""
    buf = torch.zeros(t.numel() + offset_words, dtype=t.dtype, device=t.device)
    view = buf[offset_words:].view(t.shape)
    view.copy_(t)
    return view


def _exchange_timed(ex, args, label: str, cold_l2: bool = False) -> dict:
    """One exchange operand set at the engine's call (counts off): its two
    times, its byte bound, new bits per word and the share of the bound.
    ``cold_l2``: operands small enough to stay in the L2 between back-to-back
    calls (a shard tile) are timed with the L2 flushed before each call, as
    the path meets them; the back-to-back time is kept as
    ``device_ms_warm_l2``."""
    out = ex.exchange(*args, want_counts=False)
    torch.cuda.synchronize()
    new_bits = int(ex.popcount_u32(out[0] ^ args[0]).sum())
    n, w = args[0].shape
    # per word: two ORs, an XOR, a store and a popcount; one add per new
    # bit; the per-row reduction (about one add per word)
    ops = 5.0 * n * w + new_bits + n * w
    def call():
        return ex.exchange(*args, want_counts=False)

    r = dict(
        _times(call, 50, "exchange_kernel", evict=cold_l2),
        bound=_bound(_nbytes(args) + _nbytes(out), ops),
        new_bits=new_bits,
        new_bits_per_word=new_bits / (n * w),
    )
    if cold_l2:
        r["device_ms_warm_l2"] = _device_ms(call, 50, "exchange_kernel")[0]
    r["share_of_bound"] = r["bound"][0] / r["device_ms"]
    plan = _exchange_plan(ex, args)
    if plan is not None:
        r["plan"] = plan._asdict()
    print("exchange %s: device %.4f ms%s, call %.4f ms, bound %.4f ms (%s), %.1f%% of the bound, "
          "%.3f new bits a word, plan %s"
          % (label, r["device_ms"],
             " (L2 flushed; back to back %.4f ms)" % r["device_ms_warm_l2"] if cold_l2 else "",
             r["call_ms"], r["bound"][0], r["bound"][1], 100 * r["share_of_bound"],
             r["new_bits_per_word"], r.get("plan")), flush=True)
    return r


def check_exchange(dev) -> dict:
    """Phase 3, ``exchange``: the kernel against its plain version at the
    storm shape and at ragged shapes, tables staged in shared memory past
    48 KB and read from global memory, and views off a 16-byte boundary,
    with and without counts; its times, its plain version's time and its
    bound at the storm shape, at the same shape with no new bit (the bit
    walk idle: the memory traffic alone) and at each smaller shape."""
    from ringpop_tpu_torch.ops import exchange as ex

    err = 0
    storm_args = None
    ragged = {}
    cases = [(N_STORM, 16, 0)] + [(1000, w, 0) for w in (1, 3, 4, 8, 16, 40, 512, 2048)]
    # 4-word lanes with a ragged last tile, and views off and on a 16-byte
    # boundary (4-byte and 4-word lanes)
    cases += [(1025, 4, 0), (200_001, 4, 0), (100_001, 8, 0), (100_001, 16, 0),
              (1000, 16, 1), (100_001, 16, 16)]
    for n, w, offset in cases:
        args = _exchange_inputs(n, w, 7 + w, dev)
        if offset:
            args = tuple(_exchange_view(t, offset) for t in args[:3]) + args[3:]
        plan = _exchange_plan(ex, args)
        for counts in (True, False):
            got = ex.exchange(*args, want_counts=counts)
            want = ex.exchange_plain(*args, want_counts=counts)
            torch.cuda.synchronize()
            err = max(err, _same(tuple(got), tuple(want), "exchange n=%d w=%d offset=%d counts=%s"
                                 % (n, w, offset, counts)))
        print("exchange n=%d w=%d offset=%d words: bitwise equal to its plain version with and "
              "without counts; plan %s" % (n, w, offset, plan), flush=True)
        if n == N_STORM:
            storm_args = args
        else:
            label = "n%d_w%d" % (n, w) + ("_offset%d" % offset if offset else "")
            ragged[label] = _exchange_timed(ex, args, label)
    r = _exchange_timed(ex, storm_args, "N=%d W=16 synthetic" % N_STORM)
    r["plain_ms"] = _time_ms(lambda: ex.exchange_plain(*storm_args, want_counts=False), 5)
    r["max_abs_err"] = err
    r["ragged"] = ragged
    quiet = (storm_args[0], torch.zeros_like(storm_args[1]), torch.zeros_like(storm_args[2]),
             storm_args[3])
    r["no_new_bits"] = _exchange_timed(ex, quiet, "N=%d W=16 no new bit" % N_STORM)
    print("exchange: device %.4f ms, call %.4f ms, plain %.4f ms, bound %.4f ms (%s) at N=%d "
          "W=16, %d new bits" % (r["device_ms"], r["call_ms"], r["plain_ms"], r["bound"][0],
                                 r["bound"][1], N_STORM, r["new_bits"]), flush=True)
    return r


class _ExchangeCapture:
    """Stands in for ``ops.exchange.exchange`` during a storm run and keeps
    clones of the operands of the calls numbered in ``keep`` (one call a
    tick).  The wrapper's body counts its launch on the module's
    ``exchange``, which is this object while it is bound: ``launches``
    reads and writes the wrapper's own count."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls, self.kept = fn, keep, 0, {}

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __call__(self, *args, **kw):
        if self.calls in self.keep:
            self.kept[self.calls] = tuple(t.clone() for t in args[:4])
        self.calls += 1
        return self.fn(*args, **kw)


# the storm ticks whose exchange operands are kept: the spread after the
# kill at tick 2, and after the revive at tick 30
STORM_CAPTURE_TICKS = (4, 32)
STORM_CAPTURED = {}
# planes-off references for the obs paths: the 1M storm's cold run and the
# routed storms' incremental runs, keyed by n
STORM_COLD = {}
ROUTE_RUNS = {}
# the 1M storm's warm run, the uninterrupted twin of the checkpointed path:
# host copies of its final state, its numbers and its ring digest
STORM_WARM = {}
# the planes-on 1M storm of storm_planes_headline, the twin of the mesh's
# planes path: its metrics, first_heard, hist (before the drain),
# wavefront summary and numbers
STORM_PLANES = {}


def check_exchange_storm_operands(ex_report: dict) -> None:
    """Times the kernel on the operands kept from the 1M storm's run (its
    own inputs, not synthetic ones), after the main path's counts are read:
    equal to its plain version, and how far the bit walk weighs there."""
    from ringpop_tpu_torch.ops import exchange as ex

    if sorted(STORM_CAPTURED) != list(STORM_CAPTURE_TICKS):
        raise AssertionError("kept the storm's exchange operands of ticks %s, not %s"
                             % (sorted(STORM_CAPTURED), STORM_CAPTURE_TICKS))
    cases = {}
    for tick, args in sorted(STORM_CAPTURED.items()):
        _same(tuple(ex.exchange(*args)), tuple(ex.exchange_plain(*args)),
              "exchange storm tick %d" % tick)
        cases["tick_%d" % tick] = _exchange_timed(ex, args, "1M storm tick %d" % tick)
    ex_report["storm_operands"] = cases


# ---------------------------------------------------------------------------
# n=4096 scalable storm: card (kernel) vs CPU (plain versions)


def _mid_storm_schedule(n, ticks):
    import numpy as np

    from ringpop_tpu_torch.models.sim.storm import StormSchedule

    sched = StormSchedule.churn_storm(ticks, n, 0.10, fail_tick=2, seed=1)
    part = np.full((ticks, n), -1, np.int32)
    part[5] = 0
    part[5, n // 2:] = 1
    part[20] = 0
    sched.partition = part
    return sched


def _truth_string_hash(state, universe, params) -> int:
    from ringpop_tpu_torch.ops import checksum_encode as ce
    from ringpop_tpu_torch.ops import farmhash32

    status = state.truth_status.to("cpu").numpy()
    inc = state.truth_inc.to("cpu").numpy()
    members = sorted(
        (a, ce.STATUS_STRINGS[int(status[j])],
         params.epoch + (int(inc[j]) - 1) * 200 if inc[j] > 0 else 0)
        for j, a in enumerate(universe.addresses)
    )
    return farmhash32.hash32(";".join("%s%s%d" % m for m in members))


def check_storm_e2e(n=N_MID, ticks=40):
    """Phase 4, scalable: the storm on the card equals the CPU on every
    state and metric field of every tick, with TF32 matmuls off and on;
    the truth checksum equals the host string hash."""
    import numpy as np

    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.cluster import _tick_at, default_addresses
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster
    from ringpop_tpu_torch.ops import checksum_encode as ce
    from ringpop_tpu_torch.ops import u32

    params = es.ScalableParams(n=n, u=512, packet_loss=0.05, suspicion_ticks=5)
    sched = _mid_storm_schedule(n, ticks)
    cpu = ScalableCluster(n=n, params=params, seed=2, device="cpu")
    assert cpu.params.fused_exchange == "plain"
    ins = sched.as_inputs(cpu.device)
    want = []
    for t in range(ticks):
        m = cpu.step(_tick_at(ins, t))
        want.append((convert.scalable_state_to_numpy(cpu.state), m))
    fired = {f: int(sum(getattr(m, f) for _, m in want))
             for f in ("suspects_published", "faulties_published", "refutes_published")}
    if min(fired.values()) == 0:
        raise AssertionError("the n=%d storm did not fire every batch: %r" % (n, fired))
    universe = ce.Universe.from_addresses(default_addresses(n))
    host_truth = _truth_string_hash(cpu.state, universe, cpu.params)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            card = ScalableCluster(n=n, params=params, seed=2, device="cuda")
            assert card.params.fused_exchange == "kernel"
            inexact = 0  # ticks whose mean_heard_frac is not bitwise (must be 0)
            cins = sched.as_inputs(card.device)
            for t in range(ticks):
                m = card.step(_tick_at(cins, t))
                ws, wm = want[t]
                label = "n=%d storm tf32=%s tick %d" % (n, tf32, t)
                inexact += _scalable_metrics_same(m, wm, label)
                got = convert.scalable_state_to_numpy(card.state)
                for f in es.ScalableState._fields:
                    if (got[f] is None) != (ws[f] is None) or (
                        got[f] is not None and not np.array_equal(got[f], ws[f])
                    ):
                        raise AssertionError("%s: state %s differs" % (label, f))
            _no_inexact(inexact, "n=%d storm tf32=%s" % (n, tf32))
            full = es.compute_checksums(card.state, card.params)
            if not torch.equal(full, card.state.checksum):
                raise AssertionError("n=%d tf32=%s: incremental checksums != recompute" % (n, tf32))
            truth = int(u32.to_numpy(es.farmhash_truth_checksum(card.state, universe, card.params)))
            if truth != host_truth:
                raise AssertionError("n=%d tf32=%s: truth checksum %#x != host FarmHash32 %#x"
                                     % (n, tf32, truth, host_truth))
            print("n=%d storm tf32=%s: %d ticks, card == cpu on every state and metric "
                  "field (mean_heard_frac not bitwise on %d ticks); truth checksum %#010x == host "
                  "FarmHash32; fired %s"
                  % (n, tf32, ticks, inexact, truth, json.dumps(fired)), flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def check_storm_planes_e2e(n=N_MID, ticks=40):
    """Phase 4, scalable with its obs planes (``wavefront``,
    ``histograms``, ``exchange_metrics=4``): the same storm on the card
    equals the CPU on every state field (first_heard, hist, exch and
    exch_hist included) and metric of every tick, and the drained
    summaries are equal."""
    import numpy as np

    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.cluster import _tick_at
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster

    params = es.ScalableParams(n=n, u=512, packet_loss=0.05, suspicion_ticks=5,
                               wavefront=True, histograms=True, exchange_metrics=4)
    sched = _mid_storm_schedule(n, ticks)
    pair = [ScalableCluster(n=n, params=params, seed=2, device=d) for d in ("cpu", "cuda")]
    ins = [sched.as_inputs(c.device) for c in pair]
    inexact = 0  # ticks whose mean_heard_frac is not bitwise (must be 0)
    for t in range(ticks):
        wm, gm = (c.step(_tick_at(i, t)) for c, i in zip(pair, ins))
        label = "n=%d storm planes tick %d" % (n, t)
        inexact += _scalable_metrics_same(gm, wm, label)
        want, got = (convert.scalable_state_to_numpy(c.state) for c in pair)
        for f in es.ScalableState._fields:
            if (got[f] is None) != (want[f] is None) or (
                    got[f] is not None and not np.array_equal(got[f], want[f])):
                raise AssertionError("%s: state %s differs" % (label, f))
    _no_inexact(inexact, "n=%d storm planes" % n)
    drains = [(c.wavefront_summary(), c.drain_histograms(), c.drain_exchange_metrics())
              for c in pair]
    if drains[0] != drains[1]:
        raise AssertionError("n=%d storm planes: the drained summaries differ" % n)
    wave, hist, exch = drains[1]
    print("n=%d storm with wavefront, histograms, exchange_metrics=4: %d ticks, card == cpu on "
          "every state field (first_heard, hist, exch, exch_hist) and metric (mean_heard_frac "
          "not bitwise on %d ticks); drains equal: %d rumors in the wavefront summary, rumor_age "
          "count %d p50 %s, exchange ticks %s"
          % (n, ticks, inexact, len(wave["rumors"]), hist["rumor_age"]["count"],
             hist["rumor_age"]["p50"], [r["ticks"] for r in exch["shards"]]), flush=True)


# ---------------------------------------------------------------------------
# n=4096 routed storm: card (kernel) vs CPU (plain versions)


def _route_state_same(got: dict, want: dict, label: str) -> None:
    """Every RouteState field (the ring's fields too) equal, dtype and all."""
    import numpy as np

    for f, w in want.items():
        g = got[f]
        pairs = ([(f + "." + k, g[k], w[k]) for k in w] if isinstance(w, dict)
                 else [(f, g, w)])
        for name, a, b in pairs:
            if (a is None) != (b is None) or (b is not None and (
                    a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b))):
                raise AssertionError("%s: route state %s differs" % (label, name))


def check_route_e2e(n=N_MID, ticks=30):
    """Phase 4, routed: a 10% churn storm (fail at tick 1, rejoin at 15)
    under the routing plane with request traces on, in both ring
    implementations, with the route histograms on: every RouteState (hist
    included), RouteMetrics and ScalableMetrics field on the card equals
    the CPU's on every tick (``mean_heard_frac`` too, bitwise),
    and so do the drained request records and histograms."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.route.plane import RoutedStorm, RouteParams
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.cluster import _tick_at
    from ringpop_tpu_torch.models.sim.storm import StormSchedule

    sched = StormSchedule.churn_storm(ticks, n, 0.10, fail_tick=1, rejoin_tick=15, seed=1)
    for impl in ("incremental", "full"):
        route = RouteParams(n=n, queries_per_tick=4096, reqtrace=True, req_sample_log2=1,
                            ring_impl=impl, histograms=True)
        params = es.ScalableParams(n=n, u=512)
        storms = [RoutedStorm(n, params=params, route=route, seed=3, device=d)
                  for d in ("cpu", "cuda")]
        ins = [sched.as_inputs(s.device) for s in storms]
        totals = {}
        inexact = 0  # ticks whose mean_heard_frac is not bitwise (must be 0)
        for t in range(ticks):
            (wem, wrm), (gem, grm) = (s.step(_tick_at(i, t)) for s, i in zip(storms, ins))
            label = "n=%d routed %s tick %d" % (n, impl, t)
            inexact += _scalable_metrics_same(gem, wem, label)
            for f in grm._fields:
                if getattr(grm, f) != getattr(wrm, f):
                    raise AssertionError("%s: route metric %s %r vs %r"
                                         % (label, f, getattr(grm, f), getattr(wrm, f)))
                totals[f] = totals.get(f, 0) + int(getattr(grm, f))
            _route_state_same(convert.route_state_to_numpy(storms[1].rstate),
                              convert.route_state_to_numpy(storms[0].rstate), label)
            got = convert.scalable_state_to_numpy(storms[1].cluster.state)
            want = convert.scalable_state_to_numpy(storms[0].cluster.state)
            for f, w in want.items():
                if (got[f] is None) != (w is None) or (w is not None and not (got[f] == w).all()):
                    raise AssertionError("%s: state %s differs" % (label, f))
        _no_inexact(inexact, "n=%d routed %s" % (n, impl))
        if storms[0].ring_checksum() != storms[1].ring_checksum():
            raise AssertionError("n=%d routed %s: ring checksums differ" % (n, impl))
        drained = [s.drain_requests() for s in storms]
        if drained[0] != drained[1]:
            raise AssertionError("n=%d routed %s: drained request records differ" % (n, impl))
        hists = [s.drain_histograms() for s in storms]
        if hists[0] != hists[1] or not hists[1]["route"]["retry_depth"]["count"]:
            raise AssertionError("n=%d routed %s: drained histograms differ or are empty"
                                 % (n, impl))
        if min(totals["route_misroutes"], totals["route_checksums_differ"],
               totals["route_ring_changed"]) == 0:
            raise AssertionError("n=%d routed %s: the storm did not disturb routing: %r"
                                 % (n, impl, totals))
        print("n=%d routed storm %s: %d ticks, card == cpu on every RouteState (hist included), "
              "RouteMetrics and ScalableMetrics field (mean_heard_frac not bitwise on %d ticks); "
              "%d request records drained (%d dropped); histograms drained equal (retry_depth "
              "count %d); totals %s"
              % (n, impl, ticks, inexact, len(drained[1]["records"]), drained[1]["drops"],
                 hists[1]["route"]["retry_depth"]["count"], json.dumps(totals)), flush=True)


# ---------------------------------------------------------------------------
# the main paths


def headline(mode: str) -> dict:
    import numpy as np

    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
    from ringpop_tpu_torch.ops import farmhash32

    sim = SimCluster(n=N_HEAD, params=engine.SimParams(n=N_HEAD, checksum_mode=mode),
                     device="cuda")
    t0 = time.perf_counter()
    sim.bootstrap()
    converged_in = sim.run_until_converged(max_ticks=96, quiet_after=1)
    if converged_in < 0:
        raise AssertionError("%s: n=%d did not converge within 96 ticks" % (mode, N_HEAD))
    torch.cuda.synchronize()
    converge_s = time.perf_counter() - t0
    sched = EventSchedule(ticks=TICKS, n=N_HEAD)
    sim.run(sched)  # warm
    torch.cuda.synchronize()
    warm_replays = sim.parity_replays
    t0 = time.perf_counter()
    metrics = sim.run(sched)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    groups = sim.checksum_groups()
    if len(groups) != 1 or not bool(np.asarray(metrics.converged)[-1]):
        raise AssertionError("%s: %d checksum groups after the window" % (mode, len(groups)))
    out = dict(
        mode=mode,
        n=N_HEAD,
        ticks=TICKS,
        converged_in=converged_in,
        converge_s=converge_s,
        window_s=elapsed,
        node_ticks_per_s=N_HEAD * TICKS / elapsed,
        replays=sim.parity_replays - warm_replays,
        checksum_groups=len(groups),
    )
    if mode == "farmhash":
        want = farmhash32.hash32(sim.checksum_string_of(0))
        got = int(sim.checksums()[0])
        if got != want:
            raise AssertionError("node 0 checksum %#x != host farmhash32 %#x" % (got, want))
        out["node0_checksum"] = "%#010x" % got
        out["checksum_string_bytes"] = len(sim.checksum_string_of(0))
    print("headline %s" % json.dumps(out), flush=True)
    return out


def _storm_config():
    """benchmarks/storm_1m.py's params and schedule."""
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import StormSchedule

    params = es.ScalableParams(n=N_STORM, u=512, checksum_in_tick=True)
    return params, StormSchedule.churn_storm(STORM_TICKS, N_STORM, fraction=0.10, fail_tick=2,
                                             seed=0)


def storm_headline() -> list:
    """The 1M-node churn storm as benchmarks/storm_1m.py runs it: a cold
    run, then a warm run on a fresh cluster with seed + 1 (whose final
    state the checkpointed path's victim is held to)."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster
    from ringpop_tpu_torch.ops import exchange as ex

    n, ticks = N_STORM, STORM_TICKS
    params, sched = _storm_config()
    runs = []
    for label, seed in (("cold", 0), ("warm", 1)):
        cluster = ScalableCluster(n=n, params=params, seed=seed, device="cuda")
        ring_before = cluster.ring_checksum()
        torch.cuda.synchronize()
        launches0, reads0 = ex.exchange.launches, es.host_read.count
        # the cold run keeps the exchange operands of two ticks
        kernel = ex.exchange
        capture = _ExchangeCapture(kernel, STORM_CAPTURE_TICKS) if label == "cold" else None
        if capture is not None:
            ex.exchange = capture
        try:
            t0 = time.perf_counter()
            metrics = cluster.run(sched)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ex.exchange = kernel
        if capture is not None:
            STORM_CAPTURED.update(capture.kept)
            # the planes-off reference of the storm-with-planes path
            STORM_COLD.update(metrics=metrics, checksum=cluster.state.checksum.clone(),
                              host_syncs_per_tick=(es.host_read.count - reads0) / ticks)
        launches = ex.exchange.launches - launches0
        reads = es.host_read.count - reads0
        if launches != ticks:
            raise AssertionError("storm %s: %d exchange launches in %d ticks" % (label, launches, ticks))
        live = int(metrics.live_nodes[-1])
        if live != n:
            raise AssertionError("storm %s: %d of %d nodes live at the end" % (label, live, n))
        if not torch.equal(es.compute_checksums(cluster.state, cluster.params),
                           cluster.state.checksum):
            raise AssertionError("storm %s: incremental checksums != the full recompute" % label)
        out = dict(
            run=label,
            seed=seed,
            n=n,
            ticks=ticks,
            wall_s=wall,
            node_ticks_per_s=n * ticks / wall,
            ms_per_tick=wall / ticks * 1e3,
            host_syncs_per_tick=reads / ticks,
            exchange_launches=launches,
            final_distinct_checksums=int(metrics.distinct_checksums[-1]),
            final_live_nodes=live,
            suspects_published=int(metrics.suspects_published.sum()),
            faulties_published=int(metrics.faulties_published.sum()),
            refutes_published=int(metrics.refutes_published.sum()),
            ring_checksum_before="%#010x" % ring_before,
            ring_checksum_after="%#010x" % cluster.ring_checksum(),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        print("storm %s" % json.dumps(out), flush=True)
        runs.append(out)
        if label == "warm":
            STORM_WARM.update(state=convert.state_arrays(cluster.state), out=out, seed=seed)
        del cluster
    return runs


def _route_window(n: int, q: int, ticks: int, churn: int, impl: str, histograms: bool = False):
    """One configuration of the routed storm in one ring implementation:
    ``RoutedStorm(n, ScalableParams(n), RouteParams(queries_per_tick=q))``,
    a warm window then a timed one over the same sparse-churn schedule
    (the state runs on).  Returns the timed window's numbers, both
    windows' metrics, the truth ring and, with ``histograms``, the
    drained route histograms."""
    from ringpop_tpu_torch.models.route.plane import RoutedStorm, RouteParams
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import StormSchedule
    from ringpop_tpu_torch.ops import exchange as ex

    torch.cuda.reset_peak_memory_stats()
    rs = RoutedStorm(n, params=es.ScalableParams(n=n),
                     route=RouteParams(n=n, queries_per_tick=q, ring_impl=impl,
                                       histograms=histograms), seed=0, device="cuda")
    sched = StormSchedule.sparse_churn(ticks, n, churn)
    windows = []
    for label in ("warm", "timed"):
        torch.cuda.synchronize()
        launches0, reads0 = ex.exchange.launches, es.host_read.count
        t0 = time.perf_counter()
        em, rm = rs.run(sched)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ex.exchange.launches - launches0
        if launches != ticks:
            raise AssertionError("routed n=%d %s %s: %d exchange launches in %d ticks"
                                 % (n, impl, label, launches, ticks))
        windows.append((label, wall, es.host_read.count - reads0, em, rm))
    _, wall, reads, em, rm = windows[-1]
    out = dict(
        n=n, q=q, ticks=ticks, churn_per_tick=churn, ring_impl=rs.route_params.ring_impl,
        bucket_bits=rs.route_params.bucket_bits, segment_cap=int(rs.buckets.keys.shape[1]),
        wall_s=wall, ms_per_tick=wall / ticks * 1e3, queries_per_s=q * ticks / wall,
        lookups_per_s=4 * q * ticks / wall, host_syncs_per_tick=reads / ticks,
        warm_ms_per_tick=windows[0][1] / ticks * 1e3,
        full_rebuilds_per_tick={w[0]: [int(x) for x in w[4].route_ring_full_rebuilds]
                                for w in windows},
        dirty_buckets_per_tick=[int(x) for x in rm.route_ring_dirty_buckets],
        route_queries=int(rm.route_queries.sum()),
        misroutes=int(rm.route_misroutes.sum()),
        keys_diverged=int(rm.route_keys_diverged.sum()),
        checksum_rejects=int(rm.route_checksum_rejects.sum()),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        histograms=histograms,
    )
    print("routed %s" % json.dumps(out), flush=True)
    metrics = [(w[3], w[4]) for w in windows]
    return out, metrics, rs.truth_ring(), rs.drain_histograms() if histograms else None


def _route_pair(n: int, q: int, ticks: int, churn: int) -> dict:
    """Both ring implementations on one configuration; their truth rings
    and every metric stack must be equal."""
    import numpy as np

    runs = {impl: _route_window(n, q, ticks, churn, impl) for impl in ("incremental", "full")}
    (inc, m_inc, ring_inc, _), (full, m_full, ring_full, _) = runs["incremental"], runs["full"]
    # the planes-off reference of the routed-histograms path
    ROUTE_RUNS[n] = (m_inc, ring_inc)
    if not np.array_equal(ring_inc, ring_full):
        raise AssertionError("routed n=%d: the truth rings of the two impls differ" % n)
    for (em_a, rm_a), (em_b, rm_b) in zip(m_inc, m_full):
        for m_a, m_b in ((em_a, em_b), (rm_a, rm_b)):
            for f in m_a._fields:
                if not np.array_equal(getattr(m_a, f), getattr(m_b, f)):
                    raise AssertionError("routed n=%d: metric %s differs across impls" % (n, f))
    if min(inc["route_queries"], full["route_queries"]) <= 0:
        raise AssertionError("routed n=%d: no query was routed" % n)
    return dict(incremental=inc, full=full, ring_points=int(m_inc[-1][1].route_ring_points[-1]),
                rings_equal=True, metrics_equal=True)


def _ring_rebuild_ab(n: int, r: int, ticks: int, churn: int) -> dict:
    """Ring maintenance alone, as bench.py's ``_ring_rebuild_ab``: one
    mask sequence (``churn`` random flips a tick), ``ring_kernel.update``
    with caps sized to it against a full ``build_ring`` sort every tick,
    each timed warm; the final rings and per-tick probe sums must agree."""
    import numpy as np

    from ringpop_tpu_torch.models.ring import device as ringdev
    from ringpop_tpu_torch.models.route import ring_kernel as rk
    from ringpop_tpu_torch.ops import u32

    dev = torch.device("cuda")
    reps = ringdev.device_replica_hashes(n, r, dev)
    bits = rk.default_bucket_bits(n, r)
    buckets = rk.build_buckets(reps, bits, dev)
    rng = np.random.default_rng(1)
    masks = np.ones((ticks, n), bool)
    mask = np.ones(n, bool)
    for t in range(ticks):
        flips = rng.choice(n, size=min(churn, n), replace=False)
        mask = mask.copy()
        mask[flips] = ~mask[flips]
        masks[t] = mask
    masks = torch.as_tensor(masks, device=dev)
    state0 = rk.full_rebuild(buckets, torch.ones(n, dtype=torch.bool, device=dev))
    caps = dict(max_changed=4 * churn, max_dirty=min(1 << bits, 4 * churn * r))

    def incremental():
        st, acc, rebuilds = state0, 0, 0
        for t in range(ticks):
            st, _, _, ov = rk.update(buckets, st, masks[t], **caps)
            acc = acc + st.n_points.to(torch.int64) + st.first_owner
            rebuilds = rebuilds + ov
        return rk.materialize(st, n * r), acc, rebuilds

    def full_sort():
        acc = 0
        for t in range(ticks):
            ring = ringdev.build_ring(reps, masks[t])
            npts = ringdev.ring_size(masks[t], r)
            owner0 = u32.from_u64(ring[0])  # the global min key's owner
            acc = acc + npts.to(torch.int64) + torch.where(npts > 0, owner0, -1)
        return ring, acc

    out = dict(n=n, replica_points=r, ticks=ticks, churn_per_tick=churn, bucket_bits=bits, **caps)
    results = {}
    for name, fn in (("incremental", incremental), ("full_sort", full_sort)):
        fn()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = fn()
        torch.cuda.synchronize()
        out[name + "_ms_per_tick"] = (time.perf_counter() - t0) / ticks * 1e3
    (ring_i, acc_i, rebuilds), (ring_f, acc_f) = results["incremental"], results["full_sort"]
    if not (torch.equal(ring_i, ring_f) and int(acc_i) == int(acc_f)):
        raise AssertionError("ring A/B: the incremental ring differs from the full sort")
    out["incremental_full_rebuilds"] = int(rebuilds)
    out["bitwise_equal"] = True
    print("ring_ab %s" % json.dumps(out), flush=True)
    return out


ROUTE_1M = dict(n=N_STORM, q=1 << 20, ticks=16, churn=32)  # tpu_measure.phase_route
ROUTE_100K = dict(n=100_000, q=262_144, ticks=8, churn=8)  # bench.py's route phase


def route_headline() -> dict:
    """The routed storm at full width (1M nodes, 2^20 queries a tick, 32
    kills a tick: the overflow fallback from tick 3 on), bench.py's
    100k configuration (8 kills a tick: every tick incremental), each in
    both ring implementations, and the ring-maintenance A/B at 1M."""
    out = dict(route_1m=_route_pair(**ROUTE_1M), route_100k=_route_pair(**ROUTE_100K))
    for impl in ("incremental", "full"):
        per_tick = out["route_100k"][impl]["full_rebuilds_per_tick"]
        if any(any(v) for v in per_tick.values()):
            raise AssertionError("routed n=100000 %s: a tick fell back to the full rebuild: %r"
                                 % (impl, per_tick))
    out["ring_ab_1m"] = _ring_rebuild_ab(N_STORM, 16, 32, ROUTE_1M["churn"])
    return out


def classic_headline() -> dict:
    """The classic tick and the unfused farmhash checksum path at n=1024:
    bootstrap, converge, a timed churn window, a warm and a timed quiet
    window; node 0's checksum against the host FarmHash32."""
    import numpy as np

    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
    from ringpop_tpu_torch.ops import block_loop, farmhash32

    n = N_HEAD
    params = engine.SimParams(n=n, checksum_mode="farmhash", fused_tick="off",
                              fused_checksum="off")
    sim = SimCluster(n=n, params=params, device="cuda")
    p = sim.params
    assert (p.fused_tick, p.fused_checksum, p.parity_recompute, p.hash_impl) == (
        "off", "off", "gated", "kernel"), p
    t0 = time.perf_counter()
    sim.bootstrap()
    converged_in = sim.run_until_converged(max_ticks=96, quiet_after=1)
    if converged_in < 0:
        raise AssertionError("classic: n=%d did not converge within 96 ticks" % n)
    torch.cuda.synchronize()
    converge_s = time.perf_counter() - t0
    churn = EventSchedule.churn_window(CHURN_TICKS, n)
    t0 = time.perf_counter()
    cm = sim.run(churn)
    torch.cuda.synchronize()
    churn_s = time.perf_counter() - t0
    quiet = EventSchedule(ticks=TICKS, n=n)
    sim.run(quiet)  # warm
    torch.cuda.synchronize()
    replays = sim.parity_replays
    launches = block_loop.block_loop.launches
    t0 = time.perf_counter()
    metrics = sim.run(quiet)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    groups = sim.checksum_groups()
    if len(groups) != 1 or not bool(np.asarray(metrics.converged)[-1]):
        raise AssertionError("classic: %d checksum groups after the window" % len(groups))
    want = farmhash32.hash32(sim.checksum_string_of(0))
    got = int(sim.checksums()[0])
    if got != want:
        raise AssertionError("classic: node 0 checksum %#x != host farmhash32 %#x" % (got, want))
    out = dict(
        mode="classic",
        n=n,
        ticks=TICKS,
        converged_in=converged_in,
        converge_s=converge_s,
        churn_ticks=CHURN_TICKS,
        churn_s=churn_s,
        churn_node_ticks_per_s=n * CHURN_TICKS / churn_s,
        churn_dirty_rows=int(np.asarray(cm.dirty_rows).sum()),
        churn_suspects=int(np.asarray(cm.suspects_marked).sum()),
        churn_faulties=int(np.asarray(cm.faulties_marked).sum()),
        window_s=elapsed,
        node_ticks_per_s=n * TICKS / elapsed,
        window_block_loop_launches=block_loop.block_loop.launches - launches,
        replays=sim.parity_replays - replays,
        checksum_groups=len(groups),
        node0_checksum="%#010x" % got,
        checksum_string_bytes=len(sim.checksum_string_of(0)),
    )
    print("headline %s" % json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# the obs paths: the planes on at full width, held against planes-off twins


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _profile_counts(prof, top: int):
    """Host reads (``aten::_local_scalar_dense``, one read back to the
    host), kernel launches (``cudaLaunchKernel``), device ms (every record
    of the card's activity) and the ``top`` kernels by device time, from
    the profiler's raw records (``kineto_results.events()``): its event
    tree, which ``key_averages`` builds in Python, costs seconds a tick at
    a batched tick's records."""
    from torch.autograd import DeviceType

    reads = launches = 0
    device_ns = 0
    per_kernel = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            ns = e.duration_ns()
            if ns > 0:
                device_ns += ns
                k = per_kernel.setdefault(name, [0, 0])
                k[0] += 1
                k[1] += ns
        elif name == "aten::_local_scalar_dense":
            reads += 1
        elif name in ("cudaLaunchKernel", "cuLaunchKernel"):
            launches += 1
    ranked = sorted(per_kernel.items(), key=lambda kv: kv[1][1], reverse=True)[:top]
    return reads, launches, device_ns / 1e6, [
        dict(name=k[:60], launches=c, device_ms=ns / 1e6) for k, (c, ns) in ranked]


def _profile_counts_tree(prof):
    """The same counts from ``key_averages`` (the profiler's event tree)."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    rows = prof.key_averages()
    return (sum(e.count for e in rows if e.key == "aten::_local_scalar_dense"),
            sum(e.count for e in rows if e.key in ("cudaLaunchKernel", "cuLaunchKernel")),
            sum(dev_us(e) for e in rows if e.device_type == DeviceType.CUDA and dev_us(e) > 0)
            / 1e3)


PROFILE_CROSS_CHECKED = []


def _profile_window(run, ticks: int, device, top: int = 0) -> dict:
    """``run()`` (``ticks`` ticks) under ``torch.profiler``: host reads a
    tick, kernel launches a tick, the device ms a tick and busy share of
    the window, and the ``top`` kernels by device time
    (:func:`_profile_counts`).  The first window on the card is also
    counted through ``key_averages``, as before the raw records were
    read, and both counts must agree."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        _sync(device)
        wall = time.perf_counter() - t0
    reads, launches, device_ms, kernels = _profile_counts(prof, top)
    if cuda and not PROFILE_CROSS_CHECKED:
        t_reads, t_launches, t_device_ms = _profile_counts_tree(prof)
        if (t_reads, t_launches) != (reads, launches) or abs(t_device_ms - device_ms) > 1e-3 * max(
                1.0, device_ms):
            raise AssertionError("profile counts: raw records %r, key_averages %r" % (
                (reads, launches, device_ms), (t_reads, t_launches, t_device_ms)))
        PROFILE_CROSS_CHECKED.append((reads, launches, device_ms))
        print("profile counts: raw records == key_averages (%d reads, %d launches, %.3f device "
              "ms)" % (reads, launches, device_ms), flush=True)
    out = dict(host_reads_per_tick=reads / ticks, launches_per_tick=launches / ticks,
               device_ms_per_tick=device_ms / ticks if cuda else None,
               busy_share=device_ms / 1e3 / wall if cuda else None)
    if top:
        out["top"] = kernels
    return out


def obs_headline(mode: str, n: int = N_HEAD, device="cuda", churn_ticks: int = CHURN_TICKS,
                 runlog_dir=None) -> dict:
    """The full engine with the flight recorder and the histograms on at
    ``n``: bootstrap, drain, converge (``run_until_converged(96,
    quiet_after=1)``'s loop), drain, a ``churn_ticks`` churn window, drain;
    every tick stepped beside a planes-off twin (same seed and inputs) whose
    checksums and TickMetrics must be equal on every tick.  Each window
    must drop no event and reconcile with its metrics on every field; the
    histograms must give p50/p95/p99 on every track.  Then ms/tick, host
    reads a tick and launches a tick of a churn window, planes on beside
    planes off (host reads must be equal).  With ``runlog_dir`` a run
    recorder logs the planes-on cluster; its log must validate."""
    import numpy as np

    from ringpop_tpu_torch.models.sim import engine, flight
    from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster, _tick_at
    from ringpop_tpu_torch.obs import events as oe
    from ringpop_tpu_torch.obs import recorder as orec

    t_phase = time.perf_counter()
    per_tick = flight.max_events_per_tick(n)
    cap = _pow2_at_least(per_tick)  # even the worst case of one tick fits
    base = engine.SimParams(n=n, checksum_mode=mode)
    on = SimCluster(n=n, params=base._replace(flight_recorder=True, histograms=True,
                                              event_capacity=cap), device=device)
    off = SimCluster(n=n, params=base, device=device)
    rec = None
    if runlog_dir is not None:
        rec = orec.RunRecorder(os.path.join(runlog_dir, "obs_%s.runlog.jsonl" % mode))
        on.attach_recorder(rec)

    def both(call, label):
        m_on, m_off = call(on), call(off)
        for f in engine.TickMetrics._fields:
            if not np.array_equal(getattr(m_on, f), getattr(m_off, f)):
                raise AssertionError("obs %s %s: metric %s differs with the planes on"
                                     % (mode, label, f))
        if not torch.equal(on.state.checksum, off.state.checksum):
            raise AssertionError("obs %s %s: checksums differ with the planes on" % (mode, label))
        return m_on

    def stack(ms):
        return engine.TickMetrics(*(np.stack([getattr(m, f) for m in ms])
                                    for f in engine.TickMetrics._fields))

    def drained(metrics, label):
        drops = on.event_drops()
        events = on.drain_events()
        if drops:
            raise AssertionError("obs %s %s: %d events dropped at capacity %d"
                                 % (mode, label, drops, cap))
        if metrics is not None:
            rec_ = oe.reconcile(events, metrics)
            bad = {k: v for k, v in rec_.items() if not v["match"]}
            if bad or not rec_:
                raise AssertionError("obs %s %s: reconcile mismatch %r" % (mode, label, bad))
        return len(events)

    both(lambda c: c.bootstrap(), "bootstrap")
    counts = dict(bootstrap=drained(None, "bootstrap"))
    conv, converged_in = [], -1
    for t in range(96):  # run_until_converged(96, quiet_after=1), on both
        conv.append(both(lambda c: c.step(), "converge tick %d" % t))
        if t >= 1 and bool(conv[-1].converged):
            converged_in = t + 1
            break
    if converged_in < 0:
        raise AssertionError("obs %s: n=%d did not converge within 96 ticks" % (mode, n))
    counts["converge"] = drained(stack(conv), "converge")
    sched = EventSchedule.churn_window(churn_ticks, n)
    ins = sched.as_inputs(on.device)
    churn = [both(lambda c: c.step(_tick_at(ins, t)), "churn tick %d" % t)
             for t in range(churn_ticks)]
    counts["churn"] = drained(stack(churn), "churn")
    hist = on.drain_histograms()
    for track, summ in hist.items():
        if not summ["count"] or None in (summ["p50"], summ["p95"], summ["p99"]):
            raise AssertionError("obs %s: histogram track %s is empty: %r" % (mode, track, summ))
    for f in engine.SimState._fields:
        a = getattr(off.state, f)
        if a is not None and not torch.equal(a, getattr(on.state, f)):
            raise AssertionError("obs %s: state %s differs with the planes on" % (mode, f))
    lockstep_s = time.perf_counter() - t_phase
    # the cost of the planes: the same churn window timed on both (state
    # equal), then counted under the profiler
    cost = {}
    for label, sim in (("off", off), ("on", on)):
        window = EventSchedule.churn_window(churn_ticks, n)
        _sync(device)
        t0 = time.perf_counter()
        sim.run(window)
        _sync(device)
        short = EventSchedule.churn_window(16, n)
        cost[label] = dict(ms_per_tick=(time.perf_counter() - t0) / churn_ticks * 1e3,
                           **_profile_window(lambda: sim.run(short), short.ticks, device,
                                             top=6 if label == "on" else 0))
        if label == "on":
            on.drain_events()
    if cost["on"]["host_reads_per_tick"] != cost["off"]["host_reads_per_tick"]:
        raise AssertionError("obs %s: host reads a tick %r with the planes on, %r off"
                             % (mode, cost["on"]["host_reads_per_tick"],
                                cost["off"]["host_reads_per_tick"]))
    out = dict(
        mode=mode, n=n, event_capacity=cap, max_events_per_tick=per_tick,
        events=counts, drops=0, converged_in=converged_in, churn_ticks=churn_ticks,
        reconcile="all match", neutral_ticks=1 + len(conv) + churn_ticks,
        hist={k: {q: v[q] for q in ("count", "p50", "p95", "p99")} for k, v in hist.items()},
        planes_on=cost["on"], planes_off=cost["off"],
        launches_added_per_tick=cost["on"]["launches_per_tick"] - cost["off"]["launches_per_tick"],
        lockstep_s=lockstep_s,
    )
    if rec is not None:
        rec.finish()
        problems = orec.validate_run_log(rec.path)
        if problems:
            raise AssertionError("obs %s: run log invalid: %r" % (mode, problems[:3]))
        with open(rec.path) as fh:
            out["runlog_rows"] = sum(1 for line in fh if line.strip())
    print("obs %s" % json.dumps(out), flush=True)
    return out


def obs_paths() -> list:
    """The n=1024 obs path in fast and farmhash modes; the fast run keeps
    a run log (in a temporary directory)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        return [obs_headline("fast", runlog_dir=d), obs_headline("farmhash")]


def storm_planes_headline(n: int = N_STORM, ticks: int = STORM_TICKS, device="cuda",
                          off=None) -> dict:
    """The 1M storm's schedule (the cold run of ``storm_headline``) with
    ``wavefront``, ``histograms`` and ``exchange_metrics=4`` on: one
    ``exchange`` launch a tick, metrics on every tick and the final
    checksums equal to the planes-off run, host syncs a tick equal too,
    and non-empty drains (the exchange rows counting every tick)."""
    import numpy as np

    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
    from ringpop_tpu_torch.ops import exchange as ex

    off = STORM_COLD if off is None else off
    params = es.ScalableParams(n=n, u=512, checksum_in_tick=True, wavefront=True,
                               histograms=True, exchange_metrics=4)
    sched = StormSchedule.churn_storm(ticks, n, fraction=0.10, fail_tick=2, seed=0)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cluster = ScalableCluster(n=n, params=params, seed=0, device=device)
    _sync(device)
    launches0, reads0 = ex.exchange.launches, es.host_read.count
    t0 = time.perf_counter()
    metrics = cluster.run(sched)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = ex.exchange.launches - launches0
    syncs = (es.host_read.count - reads0) / ticks
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if torch.device(device).type == "cuda" else None)
    if torch.device(device).type == "cuda" and launches != ticks:
        raise AssertionError("storm planes: %d exchange launches in %d ticks" % (launches, ticks))
    for f in es.ScalableMetrics._fields:
        if not np.array_equal(getattr(metrics, f), getattr(off["metrics"], f)):
            raise AssertionError("storm planes: metric %s differs from the planes-off run" % f)
    if not torch.equal(cluster.state.checksum.to(off["checksum"].device), off["checksum"]):
        raise AssertionError("storm planes: checksums differ from the planes-off run")
    if syncs != off["host_syncs_per_tick"]:
        raise AssertionError("storm planes: %r host syncs a tick, %r with the planes off"
                             % (syncs, off["host_syncs_per_tick"]))
    # where the planes' time goes: the fail window (ticks 0-11) under the
    # profiler, planes off and on, each on a fresh cluster
    window = StormSchedule(ticks=12, n=n, kill=sched.kill[:12], revive=sched.revive[:12])
    profiled = {}
    for label, p in (("off", params._replace(wavefront=False, histograms=False,
                                              exchange_metrics=0)), ("on", params)):
        c = ScalableCluster(n=n, params=p, seed=0, device=device)
        profiled[label] = _profile_window(lambda: c.run(window), window.ticks, device,
                                          top=6 if label == "on" else 0)
        del c
    STORM_PLANES.update(metrics=metrics, first_heard=cluster.state.first_heard,
                        hist=cluster.state.hist.clone(), ms_per_tick=wall / ticks * 1e3,
                        peak_mem_gib=peak)
    t1 = time.perf_counter()
    wave = cluster.wavefront_summary()
    STORM_PLANES["wave"] = wave
    hist = cluster.drain_histograms()
    exch = cluster.drain_exchange_metrics()
    drain_s = time.perf_counter() - t1
    if not wave["rumors"] or not hist["rumor_age"]["count"]:
        raise AssertionError("storm planes: empty wavefront summary or histograms")
    if [r["ticks"] for r in exch["shards"]] != [ticks] * 4:
        raise AssertionError("storm planes: exchange rows %r" % exch["shards"])
    out = dict(
        n=n, ticks=ticks, wall_s=wall, ms_per_tick=wall / ticks * 1e3,
        host_syncs_per_tick=syncs, exchange_launches=launches, peak_mem_gib=peak,
        metrics_equal_planes_off=True, checksums_equal_planes_off=True,
        wavefront_rumors=len(wave["rumors"]),
        wavefront_latency_histogram=wave["latency_histogram_ticks"],
        hist={k: {q: v[q] for q in ("count", "p50", "p95", "p99")} for k, v in hist.items()},
        exchange_totals=exch["totals"], exchange_cap_util_pull_p99=exch["cap_util"][
            "cap_util_pull"]["p99"], drains_s=drain_s,
        fail_window_planes_off=profiled["off"], fail_window_planes_on=profiled["on"],
    )
    print("storm planes %s" % json.dumps(out), flush=True)
    return out


def route_planes_headline() -> dict:
    """The routed 1M storm (``ROUTE_1M``, incremental ring) with
    ``RouteParams(histograms=True)``: rings and metrics equal to the
    planes-off run of ``route_headline``, the drain non-empty."""
    import numpy as np

    cfg = ROUTE_1M
    out, metrics, ring, drained = _route_window(cfg["n"], cfg["q"], cfg["ticks"], cfg["churn"],
                                                "incremental", histograms=True)
    m_off, ring_off = ROUTE_RUNS[cfg["n"]]
    if not np.array_equal(ring, ring_off):
        raise AssertionError("routed histograms: the truth ring differs from the planes-off run")
    for (em_a, rm_a), (em_b, rm_b) in zip(metrics, m_off):
        for a, b in ((em_a, em_b), (rm_a, rm_b)):
            for f in a._fields:
                if not np.array_equal(getattr(a, f), getattr(b, f)):
                    raise AssertionError("routed histograms: metric %s differs from planes off" % f)
    route = drained["route"]
    if not all(route[k]["count"] for k in route):
        raise AssertionError("routed histograms: an empty track: %r" % route)
    res = dict(out, rings_equal_planes_off=True, metrics_equal_planes_off=True,
               hist={k: {q: v[q] for q in ("count", "p50", "p95", "p99")}
                     for k, v in route.items()})
    print("routed histograms %s" % json.dumps(res), flush=True)
    return res


def _host_owner(hashes, in_ring, key: str) -> int:
    """The ring's owner of ``key`` computed on the host in numpy: the
    first replica point at or after the key's FarmHash32 in (hash, owner)
    order, wrapping to the smallest.  ``hashes``: [N, R] uint32."""
    import numpy as np

    from ringpop_tpu_torch.ops import farmhash32

    owners = np.nonzero(in_ring)[0]
    if owners.size == 0:
        return -1
    pts = np.sort((hashes[owners].astype(np.uint64) << np.uint64(32)
                   | owners[:, None].astype(np.uint64)).reshape(-1))
    i = int(np.searchsorted(pts, np.uint64(farmhash32.hash32(key)) << np.uint64(32)))
    return int(pts[i % pts.size] & np.uint64(0xFFFFFFFF))


def tick_cluster_headline(n_sim: int = N_HEAD, n_scalable: int = 100_000, device="cuda") -> dict:
    """The tick-cluster harness on the card: ``torch-sim`` at ``n_sim``
    (converge, kill, suspend/resume, revive, lookups equal to the host
    ring of node 0's view) and ``torch-sim-scalable`` at ``n_scalable``
    (converge, kill, revive, a lookup whose owner died moves to a live
    node, equal to the host ring)."""
    from ringpop_tpu_torch.api.tick_cluster import TickCluster
    from ringpop_tpu_torch.models.ring import device as ringdev
    from ringpop_tpu_torch.ops import u32

    keys = ["key-%d" % i for i in range(8)]
    out = {}
    t0 = time.perf_counter()
    tc = TickCluster.create("torch-sim", n_sim, device=device)
    tc.start()
    ticks = dict(converge=tc.tick_until_converged())
    tc.run_command("kill 3")
    ticks["after_kill"] = tc.tick_until_converged(200)
    tc.run_command("suspend 5")
    tc.tick()
    if tc.checksum_groups().get(None, []).count(tc.backend.hosts[5]) != 1:
        raise AssertionError("tick-cluster: the suspended node still reports a checksum")
    tc.run_command("revive 5")  # SIGCONT: the suspended node resumes
    ticks["after_resume"] = tc.tick_until_converged(200)
    tc.run_command("revive 3")
    ticks["after_revive"] = tc.tick_until_converged(200)
    if None in tc.checksum_groups():
        raise AssertionError("tick-cluster: a node is still dead after the revives")
    sim = tc.backend.sim
    st = sim.state
    in_ring = (st.known[0] & (st.status[0] <= 1)).to("cpu").numpy()
    hashes = ringdev.replica_table(sim.universe.addresses)
    for k in keys:
        want = sim.universe.addresses[_host_owner(hashes, in_ring, k)]
        if tc.backend.lookup(k) != want:
            raise AssertionError("tick-cluster: lookup(%s) != the host ring's %s" % (k, want))
    out["torch_sim"] = dict(n=n_sim, ticks=ticks, lookups_equal_host=len(keys),
                            display=tc.format_groups().splitlines()[-1].strip())
    sc = TickCluster.create("torch-sim-scalable", n_scalable, device=device)
    sc.start()
    s_ticks = dict(converge=sc.tick_until_converged())
    owner = sc.backend.lookup("hot-key")
    victim = sc.backend.hosts.index(owner)
    sc.run_command("kill %d" % victim)
    sc.tick()
    moved = sc.backend.lookup("hot-key")
    cl = sc.backend.cluster
    in_ring = (cl.state.proc_alive & (cl.state.truth_status <= 1)).to("cpu").numpy()
    reps = u32.to_numpy(ringdev.device_replica_hashes(n_scalable, cl.replica_points, "cpu"))
    want = "node%d" % _host_owner(reps, in_ring, "hot-key")
    if moved in (None, owner) or moved != want:
        raise AssertionError("tick-cluster scalable: lookup moved %s -> %s (host ring %s)"
                             % (owner, moved, want))
    sc.run_command("revive %d" % victim)
    s_ticks["after_revive"] = sc.tick_until_converged(200)
    out["torch_sim_scalable"] = dict(n=n_scalable, ticks=s_ticks, dead_owner=owner,
                                     moved_to=moved,
                                     display=sc.format_groups().splitlines()[-1].strip())
    out["seconds"] = time.perf_counter() - t0
    print("tick_cluster %s" % json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# the port's parity oracle on the card, and the live node
#
# The oracle (parity/oracle.py) is host code by nature: one host Membership a
# node, hashed with the C++ FarmHash; the card runs only the engine held
# against it.  Its host time grows about as n^2, so the paths are cut from
# the headline n=1024 (a run of its own, ``python -m
# ringpop_tpu_torch.parity.check -n 1024 --ticks 40``) to n=256 fused and
# n=128 classic, for the script's time limit.

PARITY_N, PARITY_TICKS = 256, 40
PARITY_CLASSIC_N, PARITY_CLASSIC_TICKS = 128, 30
LIVE_N, LIVE_BASE_PORT, LIVE_KEYS = 5, 47300, 100


def _wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from ringpop_tpu_torch.ops import block_loop, exchange, fused_apply, fused_piggyback, stream_hash

    return {"apply_updates": fused_apply.apply_updates,
            "pb_budget": fused_piggyback.pb_budget,
            "fused_stream": stream_hash.fused_stream,
            "exchange": exchange.exchange,
            "block_loop": block_loop.block_loop}


def _kernel_counts() -> dict:
    return {k: w.launches for k, w in _wrappers().items()}


def _parity_run(label: str, n: int, ticks: int, device="cuda", **knobs) -> dict:
    """``parity.check``'s lockstep loop on the card: the port's farmhash
    ``SimCluster`` on ``cuda`` against the port's ``OracleCluster`` on
    ``parity_check.py``'s schedule.  A mismatched tick raises."""
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.parity import check

    t0 = time.perf_counter()
    got = check.run_lockstep(engine.SimParams(n=n, checksum_mode="farmhash", **knobs), device,
                             check.schedule(n, ticks, seed=0), seed=0, mismatch_log=sys.stderr)
    got.update(wall_s=time.perf_counter() - t0, launches=_kernel_counts())
    print("parity %s %s" % (label, json.dumps(got)), flush=True)
    if got["mismatched_ticks"]:
        raise AssertionError("parity %s: %d of %d ticks differ from the oracle"
                             % (label, got["mismatched_ticks"], ticks))
    if not got["converged_at_end"]:
        raise AssertionError("parity %s: not converged at the end" % label)
    return got


def parity_fused_path() -> dict:
    return _parity_run("fused n=%d" % PARITY_N, PARITY_N, PARITY_TICKS)


def parity_classic_path() -> dict:
    return _parity_run("classic n=%d" % PARITY_CLASSIC_N, PARITY_CLASSIC_N, PARITY_CLASSIC_TICKS,
                       fused_tick="off", fused_checksum="off")


def _live_wait(tc, done, limit_s: float, what: str) -> float:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit_s:
        tc.tick()
        if done():
            return time.perf_counter() - t0
        time.sleep(0.1)
    raise AssertionError("live: %s not reached in %.0f s: %s" % (what, limit_s,
                                                                 tc.format_groups()))


def live_path(n: int = LIVE_N) -> dict:
    """Five node processes of the port (``TickCluster.create("live")``,
    host code: no tensor): converge to one checksum group, SIGKILL one, the
    four survivors agree again with the dead node out of every ring, and
    every survivor names the same owner for 100 keys.  No kernel."""
    from ringpop_tpu_torch.api.tick_cluster import TickCluster

    out = {"n": n}
    t0 = time.perf_counter()
    tc = TickCluster.create("live", n, base_port=LIVE_BASE_PORT)
    try:
        tc.start()
        out["start_s"] = time.perf_counter() - t0
        hosts = tc.backend.hosts
        out["converge_s"] = _live_wait(
            tc, lambda: tc.converged() and None not in tc.checksum_groups(), 60, "convergence")
        dead = hosts[-1]
        tc.backend.kill(n - 1)
        survivors = hosts[:-1]

        def reconverged():
            groups = tc.checksum_groups()
            if groups.get(None) != [dead] or not tc.converged():
                return False
            return all(dead not in tc.backend.client.admin_stats(h)["ring"] for h in survivors)

        out["reconverge_s"] = _live_wait(tc, reconverged, 90, "reconvergence after the kill")
        keys = ["key-%d" % i for i in range(LIVE_KEYS)]
        owners = [[tc.backend.lookup(k, i) for k in keys] for i in range(n - 1)]
        if any(o != owners[0] for o in owners) or dead in owners[0]:
            raise AssertionError("live: the survivors disagree on key owners")
        out.update(keys_agreed=len(keys), owners=len(set(owners[0])),
                   display=tc.format_groups().splitlines()[-1].strip())
    finally:
        tc.destroy()
    out["wall_s"] = time.perf_counter() - t0
    if any(p is not None and p.poll() is None for p in tc.backend.procs.values()):
        raise AssertionError("live: a node process outlived destroy()")
    print("live %s" % json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# the host obs layer: dispatch timers, the trace tap, the profiler harness,
# the resolution gauges and the SLO plane around the card's runs

OBS_HOST_WINDOW = 16
OBS_HOST_CAPTURE = 8
OBS_HOST_SLO_WINDOWS = 4


class _ListLogger:
    """A trace host's logger keeping every log sink's blob."""

    def __init__(self):
        self.blobs = []

    def info(self, msg, extra=None, **kw):
        self.blobs.append((extra or kw)["blob"])

    def debug(self, *a, **k):
        pass

    warning = warn = error = debug


class _CapturingStatsd:
    def __init__(self):
        self.records = []

    def increment(self, key, value=1):
        self.records.append(("increment", key, value))

    def gauge(self, key, value):
        self.records.append(("gauge", key, value))

    def timing(self, key, value):
        self.records.append(("timing", key, value))


def _schema_problems(path: str) -> list:
    """``scripts/check_metrics_schema.py``'s checks of one run log (the
    recorder's schema and the event rows' field sets) without its
    ``check()``, which reads the logs through the JAX package."""
    import importlib.util

    from ringpop_tpu_torch.obs import recorder as orec

    spec = importlib.util.spec_from_file_location(
        "check_metrics_schema", os.path.join(HERE, "scripts", "check_metrics_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return orec.validate_run_log(path) + mod._check_route_rows(path)


def obs_host_path(n: int = N_HEAD, n_mid: int = N_MID, device="cuda") -> dict:
    """The host obs layer around the card's runs.  ``SimCluster(n)`` in
    farmhash mode with ``obs_headline``'s planes (flight recorder,
    histograms, ``event_capacity`` 2^22), wrapped by ``obs.perf.wrap_cluster``
    and tapped by an ``obs.sim_tap.SimTracerHost`` (log sinks on
    ``sim.tick.metrics`` and ``sim.flight.events``, ``FakeTimers``), stepped
    beside an unwrapped, untapped twin: bootstrap, converge, a 16-tick
    churn window twice through ``obs.perf.timed_window`` (the twin's timed
    alike, in the order cluster, twin, twin, cluster), the same window
    under the profiler on each (host reads a tick equal), an 8-tick window
    through ``obs.xprof.capture`` (the twin's timed unprofiled before and
    after it), every drain equal to the twin's and every state
    field bitwise the twin's after each window; the tracer's
    ``flightEvents`` records cover each drain exactly, the 16-tick metrics
    publish 16 ``tickMetrics`` records, ``add_host_timeline`` merges a
    valid trace, the xprof row is ``ok`` with ops, and the ``perf.phase``
    and ``xprof.capture`` rows pass the schema gate.  Then
    ``emit_resolution_stat`` of that cluster and of an ``n_mid``
    ``ScalableCluster`` through a capturing bridge, and an ``n_mid``
    ``RoutedStorm(histograms=True)`` over 4 windows of 4 ticks of
    ``check_route_e2e``'s churn (10% killed at tick 1, revived at 9): each
    window's route bank read, drained with reset, and fed to an
    ``obs.slo.SLOWindowPlane(window_len=3)``; the ``slo.window`` rows pass
    the schema gate and the Prometheus text's ``_count`` lines equal the
    drained totals."""
    import re
    import tempfile

    import numpy as np

    from ringpop_tpu_torch.models.route.plane import ROUTE_HIST_TRACKS, RoutedStorm, RouteParams
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
    from ringpop_tpu_torch.net.timers import FakeTimers
    from ringpop_tpu_torch.obs import chrome_trace as oct_
    from ringpop_tpu_torch.obs import histograms as oh
    from ringpop_tpu_torch.obs import perf, prometheus, slo, xprof
    from ringpop_tpu_torch.obs.recorder import RunRecorder
    from ringpop_tpu_torch.obs.sim_tap import SimTracerHost
    from ringpop_tpu_torch.obs.statsd_bridge import StatsdBridge
    from ringpop_tpu_torch.ops import toolkit
    from ringpop_tpu_torch.ops import (
        block_loop, exchange, fused_apply, fused_piggyback, stream_hash,
    )
    from ringpop_tpu_torch.utils.trace import Tracer

    wrappers = {"apply_updates": fused_apply.apply_updates, "pb_budget": fused_piggyback.pb_budget,
                "fused_stream": stream_hash.fused_stream, "exchange": exchange.exchange,
                "block_loop": block_loop.block_loop}
    params = engine.SimParams(n=n, checksum_mode="farmhash", flight_recorder=True,
                              histograms=True, event_capacity=1 << 22)
    sim = SimCluster(n=n, params=params, device=device)
    twin = SimCluster(n=n, params=params, device=device)
    timer = perf.wrap_cluster(sim)
    host = SimTracerHost(sim, logger=_ListLogger(), timers=FakeTimers())
    for event in ("sim.tick.metrics", "sim.flight.events"):
        host.tracers.add(Tracer(host, event, {"type": "log"}))
    sim.attach_tracer(host)
    out = dict(n=n, mode="farmhash", event_capacity=params.event_capacity)

    def same_state(label):
        for f in engine.SimState._fields:
            a, b = getattr(sim.state, f), getattr(twin.state, f)
            if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                raise AssertionError("obs host %s: state %s differs from the twin" % (label, f))

    drained = []

    def drain(label):
        """Both drains equal; the tracer's flightEvents records cover this
        drain's events exactly, in order."""
        first = len(host.logger.blobs)
        events, want = sim.drain_events(), twin.drain_events()
        if events != want:
            raise AssertionError("obs host %s: the drain differs from the twin's" % label)
        recs = [b for b in host.logger.blobs[first:] if "events" in b]
        got = [(b["offset"], b["total"], len(b["events"])) for b in recs]
        exp = [(lo, len(events), min(256, len(events) - lo)) for lo in range(0, len(events), 256)]
        if got != exp or any(b["events"] and b["events"][0] is not events[b["offset"]]
                             for b in recs):
            raise AssertionError("obs host %s: flightEvents records %r, drain of %d"
                                 % (label, got[:4], len(events)))
        same_state(label)
        drained.append(len(events))
        del host.logger.blobs[first:]
        return events

    def window_ms(run, ticks):
        _sync(device)
        t0 = time.perf_counter()
        m = run()
        _sync(device)
        return m, (time.perf_counter() - t0) / ticks * 1e3

    tmp = tempfile.TemporaryDirectory()
    rec = RunRecorder(os.path.join(tmp.name, "obs_host.runlog.jsonl"), config=dict(n=n))
    try:
        for c in (sim, twin):
            c.bootstrap()
        drain("bootstrap")
        conv = [c.run_until_converged(96, quiet_after=1) for c in (sim, twin)]
        if conv[0] != conv[1] or conv[0] < 0:
            raise AssertionError("obs host: converged in %r (cluster, twin)" % conv)
        out["converged_in"] = conv[0]
        drain("converge")
        window = EventSchedule.churn_window(OBS_HOST_WINDOW, n)
        # wrapped, twin, twin, wrapped: each side's ms/tick is the mean of
        # its two windows, so the order's share of the host's drift cancels
        walls, twin_walls, ms_sim, ms_twin = [], [], [], []
        for side in ("sim", "twin", "twin", "sim"):
            if side == "sim":
                m, wall = perf.timed_window(lambda: sim.run(window), warmup=0, repeats=1,
                                            recorder=rec, phase="churn_window", timer=timer,
                                            n=n, ticks=OBS_HOST_WINDOW)
                walls.append(wall / OBS_HOST_WINDOW * 1e3)
                ms_sim.append(m)
            else:
                m, ms = window_ms(lambda: twin.run(window), OBS_HOST_WINDOW)
                twin_walls.append(ms)
                ms_twin.append(m)
        for a, b in zip(ms_sim, ms_twin):
            for f in engine.TickMetrics._fields:
                if not np.array_equal(getattr(a, f), getattr(b, f)):
                    raise AssertionError("obs host: churn window metric %s differs" % f)
        m_sim = ms_sim[0]
        first = len(host.logger.blobs)
        if host.publish_tick_metrics(m_sim, start_tick=1 + conv[0]) != OBS_HOST_WINDOW:
            raise AssertionError("obs host: publish_tick_metrics did not give %d records"
                                 % OBS_HOST_WINDOW)
        ticks = [b for b in host.logger.blobs[first:] if "metrics" in b]
        if (len(ticks) != OBS_HOST_WINDOW
                or ticks[0]["metrics"]["pings_sent"] != int(m_sim.pings_sent[0])):
            raise AssertionError("obs host: %d tickMetrics records" % len(ticks))
        out["window"] = dict(ticks=OBS_HOST_WINDOW, ms_per_tick=sum(walls) / 2,
                             twin_ms_per_tick=sum(twin_walls) / 2, walls_ms_per_tick=walls,
                             twin_walls_ms_per_tick=twin_walls, tick_metrics_records=len(ticks))
        drain("churn window")
        prof = [_profile_window(lambda c=c: c.run(window), OBS_HOST_WINDOW, device)
                for c in (sim, twin)]
        if prof[0]["host_reads_per_tick"] != prof[1]["host_reads_per_tick"]:
            raise AssertionError("obs host: host reads a tick %r wrapped, %r twin"
                                 % (prof[0]["host_reads_per_tick"], prof[1]["host_reads_per_tick"]))
        out["profiled"] = dict(wrapped=prof[0], twin=prof[1])
        drain("profiled window")
        # the twin's unprofiled window before and after the capture; the
        # cluster runs the same window unprofiled after it, to stay in step
        capture = EventSchedule.churn_window(OBS_HOST_CAPTURE, n)
        _, twin_before = window_ms(lambda: twin.run(capture), OBS_HOST_CAPTURE)
        before = {k: w.launches for k, w in wrappers.items()}
        row = xprof.capture(lambda: sim.run(capture), os.path.join(tmp.name, "xprof"),
                            phase="obs_host_capture", warmup=0, repeats=1, top_k=30,
                            recorder=rec, n=n, ticks=OBS_HOST_CAPTURE)
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        _, twin_after = window_ms(lambda: twin.run(capture), OBS_HOST_CAPTURE)
        _, sim_unprofiled = window_ms(lambda: sim.run(capture), OBS_HOST_CAPTURE)
        twin_capture_ms = (twin_before + twin_after) / 2
        if not row["ok"] or not row["ops"]:
            raise AssertionError("obs host: xprof row %r" % {k: v for k, v in row.items()
                                                              if k != "ops"})
        # each kernel's records by its symbol (``(anonymous namespace)::
        # apply_updates_kernel(...)``, ``void ...::fused_stream_kernel<9, true>(...)``)
        symbol = {t.kernel_entry: re.compile(r"(?<!\w)%s_kernel\b" % t.kernel_entry)
                  for t in toolkit.TWIN_REGISTRY}
        seen = dict.fromkeys(symbol, 0)
        for path in xprof.find_trace_files(row["trace_dir"]):
            for e in xprof.load_trace_events(path):
                if e.get("cat") == "kernel":
                    for k, pat in symbol.items():
                        if pat.search(str(e.get("name", ""))):
                            seen[k] += 1
        out["xprof"] = dict(
            ok=row["ok"], digest=row["digest"], note=row.get("note"), wall_s=row["wall_s"],
            ms_per_tick=row["wall_s"] / OBS_HOST_CAPTURE * 1e3,
            twin_unprofiled_ms_per_tick=twin_capture_ms,
            twin_unprofiled_before_after=[twin_before, twin_after],
            unprofiled_ms_per_tick=sim_unprofiled, kernel_records=row["kernel_records"],
            total_self_us=row["total_self_us"],
            top=[dict(name=o["name"][:60], self_us=o["self_us"], count=o["count"],
                      budget_entry=o["budget_entry"]) for o in row["ops"][:8]],
            keyed=[dict(name=o["name"][:60], self_us=o["self_us"], count=o["count"],
                        budget_entry=o["budget_entry"]) for o in row["ops"]
                   if o["budget_entry"]],
            kernel_records_seen={k: seen[k] for k in seen if launched[k] or seen[k]},
            launches={k: v for k, v in launched.items() if v})
        print(xprof.render_table(row), flush=True)
        events = drain("capture")
        trace = sim.export_flight_trace(events)
        oct_.add_host_timeline(trace, timer)
        problems = oct_.validate_chrome_trace(trace)
        if problems:
            raise AssertionError("obs host: merged trace invalid: %r" % problems[:3])
        out["trace_events"] = len(trace["traceEvents"])
        out["drained_events"] = drained
        if timer.emit(rec) != len(timer.phases) or set(timer.phases) != {
                "tick", "scan", "churn_window"}:
            raise AssertionError("obs host: timer phases %r" % sorted(timer.phases))
        if timer.phases["tick"].calls != 1 + conv[0] or timer.phases["scan"].calls != 5:
            raise AssertionError("obs host: tick/scan calls %d/%d" % (
                timer.phases["tick"].calls, timer.phases["scan"].calls))
        out["phases"] = {r["phase"]: dict(calls=r["calls"], p50_ms=r["p50_ms"],
                                          p95_ms=r["p95_ms"], p99_ms=r["p99_ms"])
                         for r in timer.summary()}
        rec.finish()
        problems = _schema_problems(rec.path)
        with open(rec.path) as fh:
            names = [json.loads(line).get("name") for line in fh if line.strip()]
        if problems or names.count("perf.phase") != 5 or names.count("xprof.capture") != 1:
            raise AssertionError("obs host: run log %r, rows %r" % (problems[:3], names))

        cap = _CapturingStatsd()
        bridge = StatsdBridge(statsd=cap, host_port="127.0.0.1:3000")
        sim.emit_resolution_stat(bridge)
        ScalableCluster(n_mid, params=es.ScalableParams(n=n_mid, u=512),
                        device=device).emit_resolution_stat(bridge)
        if [k.split(".", 2)[2] for _, k, _ in cap.records] != [
                "sim.fused_checksum.resolution_differs", "sim.fused_tick.resolution_differs",
                "sim.fused_exchange.resolution_differs"]:
            raise AssertionError("obs host: resolution gauges %r" % cap.records)
        out["resolution_gauges"] = {k: v for _, k, v in cap.records}

        rs = RoutedStorm(n_mid, params=es.ScalableParams(n=n_mid, u=512),
                         route=RouteParams(n=n_mid, queries_per_tick=4096, histograms=True),
                         seed=3, device=device)
        sched = StormSchedule.churn_storm(4 * OBS_HOST_SLO_WINDOWS, n_mid, 0.10, fail_tick=1,
                                          rejoin_tick=9, seed=1)
        slo_rec = RunRecorder(os.path.join(tmp.name, "slo.runlog.jsonl"), config=dict(n=n_mid))
        scap = _CapturingStatsd()
        plane = slo.SLOWindowPlane(slo.SLOTarget(), window_len=3, recorder=slo_rec,
                                   statsd=StatsdBridge(statsd=scap, host_port="127.0.0.1:3000"))
        slo_ms, totals, rows = [], [], []
        for w in range(OBS_HOST_SLO_WINDOWS):
            _, rm = rs.run(sched.window(4 * w, 4 * w + 4))
            t0 = time.perf_counter()
            bank = oh.host_counts(rs.rstate.hist)
            summary = rs.drain_histograms(reset=True)["route"]
            rows.append(plane.observe_route_window(4 * w + 4, bank, rm))
            slo_ms.append((time.perf_counter() - t0) * 1e3)
            totals.append({t: summary[t]["count"] for t in ROUTE_HIST_TRACKS})
            if [int(bank[i].sum()) for i in range(len(ROUTE_HIST_TRACKS))] != list(
                    totals[-1].values()):
                raise AssertionError("obs host: SLO window %d bank != its drain" % w)
        slo_rec.finish()
        problems = _schema_problems(slo_rec.path)
        if problems:
            raise AssertionError("obs host: SLO run log %r" % problems[:3])
        text = prometheus.render_slo_plane(plane, rows[-1]["tick"])
        pooled = sum(t["retry_depth"] for t in totals[-3:])
        if 'ringpop_slo_window_count{target="route"} %d' % pooled not in text.splitlines():
            raise AssertionError("obs host: render_slo_plane _count != %d" % pooled)
        dev_text = prometheus.render_device_histograms(bank, ROUTE_HIST_TRACKS, "ringpop_route_")
        for track, count in totals[-1].items():
            if "ringpop_route_%s_count %d" % (track, count) not in dev_text.splitlines():
                raise AssertionError("obs host: render_device_histograms %s _count != %d"
                                     % (track, count))
        if not sum(r["queries"] for r in rows) or not pooled:
            raise AssertionError("obs host: the SLO windows saw no traffic")
        out["slo"] = dict(n=n_mid, windows=len(rows), window_ticks=4, ms_per_window=slo_ms,
                          drained=totals, statsd_samples=len(scap.records), last_row=rows[-1],
                          prometheus_lines=len(text.splitlines()) + len(dev_text.splitlines()))
    finally:
        host.destroy()
        tmp.cleanup()
    print("obs host %s" % json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# the batch axis: the kernels' batching rules under torch.func.vmap, the
# batched full engine and the fuzz executors

BATCHES = (1, 4)
# ticks of the profiled windows of the batched paths (their counts are read
# from the profiler's raw records: see _profile_counts)
PROFILE_TICKS = 16
FUZZ_FULL = dict(engine="full", n=8, ticks=24, loss_levels=(0.0, 0.05, 0.2))
FUZZ_SCALABLE = dict(engine="scalable", n=32, ticks=24, loss_levels=(0.0, 0.05, 0.2))
# the port's kernel modules and the kernel each one's batching rule launches
RULE_MODULES = (("fused_apply", "apply_updates"), ("fused_piggyback", "pb_budget"),
                ("stream_hash", "fused_stream"), ("block_loop", "block_loop"),
                ("exchange", "exchange"))


def _shape_key(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, (tuple, list)):
        return tuple(_shape_key(y) for y in x)
    return x


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return tuple(_clone(y) for y in x)
    return x


class _RuleCapture:
    """Stands in for each kernel module's ``_clusters`` — the body of its
    batching rule, which receives the real ``[B, ...]`` operands and
    launches the kernel once — while a main path runs: every call passes
    through, and the operands and results of the first call at each
    (kernel, operand shapes, options) are kept for
    :func:`_check_rule_capture`."""

    def __enter__(self):
        import importlib

        self.kept = {}
        self.saved = []
        for module, kernel in RULE_MODULES:
            mod = importlib.import_module("ringpop_tpu_torch.ops." + module)
            self.saved.append((mod, mod._clusters))
            mod._clusters = self._stand_in(kernel, mod._clusters)
        return self

    def _stand_in(self, kernel, fn):
        def call(*args):
            out = fn(*args)
            key = (kernel, _shape_key(args))
            if key not in self.kept:
                self.kept[key] = (_clone(args), _clone(out))
            return out
        return call

    def __exit__(self, *exc):
        for mod, fn in self.saved:
            mod._clusters = fn
        return False


def _plain_clusters(kernel, args):
    """The plain version of one batching-rule call on the same ``[B, ...]``
    operands, in the rule's output order (``apply_updates``' applied count
    per cluster; the kernel returns it per row)."""
    from ringpop_tpu_torch.ops import block_loop as bl
    from ringpop_tpu_torch.ops import exchange as ex
    from ringpop_tpu_torch.ops import fused_apply as fa
    from ringpop_tpu_torch.ops import fused_piggyback as fp
    from ringpop_tpu_torch.ops import stream_hash as sh

    if kernel == "apply_updates":
        planes, now, deadline, union, want_masks, want_count, want_refute, lo = args
        o = fa.apply_updates_plain(fa.ApplyState(*planes[:10]), *planes[10:], now, deadline,
                                   union, want_masks=want_masks, want_count=want_count,
                                   want_refute=want_refute, lo=lo)
        return (*o.state, o.union, o.applied, o.applied_rows, o.applied_count, o.refute_diag)
    if kernel == "pb_budget":
        return tuple(fp.pb_budget_plain(*args[:5], want_content=args[5]))
    if kernel == "exchange":
        return ex.exchange_plain(*args[:4], want_counts=args[4])
    # the hash loops: rows are independent, so the B clusters' rows are
    # one plain call
    ops = args[0] if kernel == "fused_stream" else args
    lead = tuple(ops[0].shape)
    flat = [t.reshape((-1,) + tuple(t.shape[2:])) for t in ops]
    plain = sh.fused_stream_plain if kernel == "fused_stream" else bl.block_loop_plain
    return tuple(t.reshape(lead) for t in plain(*flat))


def _check_rule_capture(kept, label: str) -> dict:
    """Each kept batching-rule call: the kernel's results (as the main path
    got them) bitwise equal to the plain version on the same operands.
    Returns the shapes held, per kernel."""
    held = {}
    for (kernel, _), (args, got) in kept.items():
        want = _plain_clusters(kernel, args)
        got = list(got)
        if kernel == "apply_updates" and got[13] is not None and got[13].dim() == 2:
            got[13] = got[13].sum(dim=-1, dtype=torch.int32)  # per row -> per cluster
        first = args[0][0] if kernel in ("apply_updates", "fused_stream") else args[0]
        what = "%s %s %s" % (label, kernel, "x".join(str(d) for d in first.shape))
        _same(tuple(got), tuple(want), what)
        held.setdefault(kernel, []).append(list(first.shape))
    return held


def _stack(per_cluster):
    """B per-cluster operand tuples -> one tuple of [B, ...] tensors."""
    return tuple(torch.stack(list(xs)) for xs in zip(*per_cluster))


def _batch_case(wrapper, call, per_cluster, want, label, symbol=None) -> dict:
    """One kernel at one batch: ``vmap`` of the wrapper over the stacked
    operands launches the kernel once, and equals the B single-cluster
    launches and ``want`` (the plain version's outputs, cluster first),
    bitwise.  Timed (``device_ms`` of the one launch, ``call_ms`` of the
    vmapped call) when ``symbol`` is given, with its byte bound."""
    from torch.func import vmap

    args = _stack(per_cluster)
    vfn = vmap(lambda *a: tuple(_leaves(tuple(call(a)))))
    before = wrapper.launches
    got = vfn(*args)
    torch.cuda.synchronize()
    if wrapper.launches - before != 1:
        raise AssertionError("%s: %d launches for one batched call"
                             % (label, wrapper.launches - before))
    err = 0
    for i, single_args in enumerate(per_cluster):
        single = tuple(_leaves(tuple(call(single_args))))
        err = max(err, _same(tuple(g[i] for g in got), single, "%s cluster %d" % (label, i)))
        err = max(err, _same(single, tuple(w[i] for w in want), "%s cluster %d plain" % (label, i)))
    out = dict(max_abs_err=err, launches_per_call=1)
    if symbol is not None:
        out.update(_times(lambda: vfn(*args), 20, symbol))
        out["bound"] = _bound(_nbytes(args) + _nbytes(got), 0.0)
        out["bound_ms"] = out["bound"][0]
    return out


def _per_cluster_plain(plain_call, per_cluster):
    """The plain version's outputs for each cluster, stacked cluster first."""
    outs = [tuple(_leaves(tuple(plain_call(a)))) for a in per_cluster]
    return tuple(torch.stack(list(xs)) for xs in zip(*outs))


def _rows_plain(plain, per_cluster):
    """A row-wise plain version (the hash loops: rows are independent) run
    once over every cluster's rows, split back per cluster: one slow plain
    call in place of B."""
    args = _stack(per_cluster)
    b, rows = args[0].shape[:2]
    flat = [a.reshape((b * rows,) + tuple(a.shape[2:])) for a in args]
    return tuple(x.reshape(b, rows) for x in plain(*flat))


def check_batch_rules(dev) -> dict:
    """Each kernel's batching rule at B in (1, 4) over check_kernels'
    shapes: one launch per batched call, equal to B single launches and
    to the plain version; the batched call's times at the main shape.
    B = 1 runs the first cluster of the B = 4 operands."""
    import numpy as np

    from ringpop_tpu_torch.ops import block_loop as bl
    from ringpop_tpu_torch.ops import exchange as ex
    from ringpop_tpu_torch.ops import fused_apply as fa
    from ringpop_tpu_torch.ops import fused_piggyback as fp
    from ringpop_tpu_torch.ops import stream_hash as sh
    from ringpop_tpu_torch.ops import u32

    top = max(BATCHES)
    report = {k: {} for k in ("apply_updates", "pb_budget", "fused_stream", "block_loop",
                              "exchange")}

    def run(name, call, plain_call, per, label, timed, rows_plain=None):
        want = (_rows_plain(rows_plain, per) if rows_plain is not None
                else _per_cluster_plain(plain_call, per))
        for b in BATCHES:
            r = _batch_case(getattr(mod[name], name), call, per[:b],
                            tuple(w[:b] for w in want), "%s B=%d %s" % (name, b, label),
                            "%s_kernel" % name if timed else None)
            if timed:
                report[name]["B=%d" % b] = r

    mod = dict(apply_updates=fa, pb_budget=fp, fused_stream=sh, block_loop=bl, exchange=ex)
    site = dict(want_masks=True, want_count=False, want_refute=True)
    counted = dict(want_masks=False, want_count=True, want_refute=False)
    for n in (N_HEAD, 1001):
        # per-cluster stamps differ: cluster i's now is 37 + i
        per = []
        for i in range(top):
            st, upd, union, now, deadline = _apply_inputs(n, 40 + i, dev)
            per.append((*st, *upd, now + i, deadline + i, union))
        for kw in (site, counted):
            run("apply_updates",
                lambda a, kw=kw: fa.apply_updates(fa.ApplyState(*a[:10]), *a[10:17], a[17], **kw),
                lambda a, kw=kw: fa.apply_updates_plain(fa.ApplyState(*a[:10]), *a[10:17], a[17],
                                                        **kw),
                per, "n=%d %s" % (n, sorted(k for k in kw if kw[k])), n == N_HEAD and kw is site)
        run("pb_budget", lambda a: fp.pb_budget(*a), lambda a: fp.pb_budget_plain(*a),
            [_budget_inputs(n, 50 + i, dev) for i in range(top)], "n=%d" % n, n == N_HEAD)
    for rows, n in ((256, N_HEAD), (16, 1001)):
        run("fused_stream", lambda a: sh.fused_stream(*a), None,
            [_stream_inputs(rows, n, 60 + i, dev) for i in range(top)],
            "%d rows x N=%d" % (rows, n), n == N_HEAD, rows_plain=sh.fused_stream_plain)
    per = [_block_inputs(256, 70 + i, dev) for i in range(top)]
    run("block_loop", lambda a: bl.block_loop(*a), None, per,
        "256 rows x I=%d" % per[0][3].shape[1], True, rows_plain=bl.block_loop_plain)
    rng = np.random.default_rng(7)
    per = [tuple(u32.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32), dev)
                 for shape in ((1000,), (1000,), (1000,), (1000, 7, 5)))
           + (torch.as_tensor(rng.integers(0, 8, 1000).astype(np.int32), device=dev),)
           for _ in range(top)]
    run("block_loop", lambda a: bl.block_loop(*a), None, per, "1000 rows x I=7", False,
        rows_plain=bl.block_loop_plain)
    per = [_exchange_inputs(100_001, 16, 80 + i, dev) for i in range(top)]
    for counts in (True, False):
        run("exchange", lambda a, c=counts: ex.exchange(*a, want_counts=c),
            lambda a, c=counts: ex.exchange_plain(*a, want_counts=c), per,
            "N=100001 W=16 counts=%s" % counts, not counts)
    for name, cases in report.items():
        print("%s batched: %s" % (name, ", ".join(
            "%s device %.4f ms call %.4f ms bound %.4f ms" % (k, v["device_ms"], v["call_ms"],
                                                              v["bound_ms"])
            for k, v in cases.items())), flush=True)
    return report


def _row_schedule(sched, t):
    """Tick ``t`` of a schedule as a one-tick schedule."""
    from ringpop_tpu_torch.models.sim.cluster import EventSchedule

    return EventSchedule(ticks=1, n=sched.n, **{
        k: None if getattr(sched, k) is None else getattr(sched, k)[t:t + 1]
        for k in ("kill", "revive", "join", "partition", "resume", "leave")})


def _fields_equal(a: dict, b: dict, what: str) -> None:
    for f in a:
        if (a[f] is None) != (b[f] is None) or (a[f] is not None and not (a[f] == b[f]).all()):
            raise AssertionError("%s: %s differs" % (what, f))


def check_batched_e2e(n=64, ticks=32, b=4):
    """Phase 4, the batch axis: ``BatchedSimClusters(b=4, n=64)`` with the
    flight recorder on, on the churn schedule, in fast, farmhash and
    classic: card == CPU on every state and metric field of every tick,
    each cluster == the card's solo ``SimCluster(gate_phases=False)`` with
    seed + i on every tick, and the drained streams equal."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.fuzz.executor import event_capacity_for
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim.batched import BatchedSimClusters
    from ringpop_tpu_torch.models.sim.cluster import SimCluster

    for mode in ("fast", "farmhash", "classic"):
        p = engine.SimParams(n=n, checksum_mode="fast" if mode == "fast" else "farmhash",
                             suspicion_ticks=6, flight_recorder=True,
                             event_capacity=event_capacity_for(n, ticks))
        if mode == "classic":
            p = p._replace(fused_tick="off", fused_checksum="off")
        bats = [BatchedSimClusters(b, n, params=p, seed=1, device=d) for d in ("cuda", "cpu")]
        assert bats[0].params.hash_impl == "kernel" and not bats[0].params.gate_phases
        solos = [SimCluster(n=n, params=p._replace(gate_phases=False), seed=1 + i, device="cuda")
                 for i in range(b)]
        sched = _churn_schedule(n, ticks)
        ms = [x.bootstrap() for x in bats]
        sms = [s.bootstrap() for s in solos]
        for t in range(ticks + 1):
            what = "batched n=%d %s tick %d" % (n, mode, t)
            for f in engine.TickMetrics._fields:
                got = getattr(ms[0], f).reshape(-1)
                if not (got == getattr(ms[1], f).reshape(-1)).all():
                    raise AssertionError("%s: metric %s card != cpu" % (what, f))
                if not all(got[i] == getattr(sms[i], f).reshape(-1)[-1] for i in range(b)):
                    raise AssertionError("%s: metric %s != solo" % (what, f))
            card = convert.state_to_numpy(bats[0].state)
            _fields_equal(card, convert.state_to_numpy(bats[1].state), what + " card != cpu")
            if t == ticks:
                for i, s in enumerate(solos):
                    _fields_equal({f: None if v is None else v[i] for f, v in card.items()},
                                  convert.state_to_numpy(s.state), "%s cluster %d != solo" % (what, i))
            if t < ticks:
                row = _row_schedule(sched, t)
                ms = [x.run(row) for x in bats]
                sms = [s.run(row) for s in solos]
        streams = bats[0].drain_events()
        if streams != bats[1].drain_events() or streams != [s.drain_events() for s in solos]:
            raise AssertionError("batched n=%d %s: drained streams differ" % (n, mode))
        print("batched n=%d b=%d %s: %d ticks, card == cpu on every state and metric field, "
              "== the solo clusters (metrics every tick, final state), %d events drained"
              % (n, b, mode, ticks + 1, sum(len(x) for x in streams)), flush=True)


def _fuzz_runs_equal(got, want, label) -> None:
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.sim import engine

    for r, w in zip(got, want):
        if r.seeds != w.seeds or r.events != w.events or r.drops != w.drops:
            raise AssertionError("%s: seeds, events or drops differ" % label)
        conv = (convert.state_to_numpy if isinstance(r.final_state, engine.SimState)
                else convert.scalable_state_to_numpy)
        _fields_equal(conv(r.final_state), conv(w.final_state), label + " final state")
        for f, x, y in zip(type(r.metrics)._fields, r.metrics, w.metrics):
            if not (x == y).all():
                raise AssertionError("%s: metric %s differs" % (label, f))


def check_fuzz_e2e():
    """Phase 4, the fuzz executors: the tier-1 smoke sweeps (full n=8 and
    scalable n=32, 8 seeds, loss 0 and 0.1) on the card equal the CPU
    (final states, metrics, event streams), with no violation; the
    scalable sweep once more through the ``exchange`` kernel."""
    from ringpop_tpu_torch.fuzz import executor as fex
    from ringpop_tpu_torch.fuzz import invariants as inv
    from ringpop_tpu_torch.fuzz import scenarios as sc
    from ringpop_tpu_torch.ops import exchange as ex

    for cfg in (sc.ScenarioConfig(engine="full", n=8, ticks=20, loss_levels=(0.0, 0.1)),
                sc.ScenarioConfig(engine="scalable", n=32, ticks=24, loss_levels=(0.0, 0.1))):
        seeds = list(range(8))
        card, cpu = (fex.sweep(seeds, cfg, device=d) for d in ("cuda", "cpu"))
        _fuzz_runs_equal(card, cpu, "fuzz %s" % cfg.engine)
        bad = {r.seeds[i]: vs for r in card for i, vs in inv.check_run(r).items()}
        if bad:
            raise AssertionError("fuzz %s: violations %s" % (cfg.engine, bad))
        if cfg.engine == "scalable":
            kernel_runs = []
            for r in cpu:
                params = r.params._replace(fused_exchange="kernel")
                before = ex.exchange.launches
                kernel_runs.append(fex.ScalableFuzzExecutor(cfg, params=params, device="cuda")
                                   .run_seeds(r.seeds))
                if ex.exchange.launches - before != cfg.ticks:
                    raise AssertionError("fuzz scalable: %d exchange launches in %d batched ticks"
                                         % (ex.exchange.launches - before, cfg.ticks))
            _fuzz_runs_equal(kernel_runs, cpu, "fuzz scalable fused_exchange=kernel")
        print("fuzz %s n=%d: %d seeds, card == cpu (final states, metrics, streams), no "
              "violation%s" % (cfg.engine, cfg.n, len(seeds),
                               "; again through the exchange kernel" if cfg.engine == "scalable"
                               else ""), flush=True)


def _one_group_per_cluster(bat) -> bool:
    import numpy as np

    cs = bat.checksums()
    live = (bat.state.proc_alive & bat.state.ready).to("cpu").numpy()
    return all(len(np.unique(cs[i][live[i]])) == 1 for i in range(bat.b))


def _checksum_string(bat, b: int, i: int) -> str:
    """Node i of cluster b's checksum string (``SimCluster.checksum_string_of``)."""
    p = bat.params
    known = bat.state.known[b, i].to("cpu").numpy()
    status = bat.state.status[b, i].to("cpu").numpy()
    inc = bat.state.inc[b, i].to("cpu").numpy()
    from ringpop_tpu_torch.ops import checksum_encode as ce

    return ";".join(
        "%s%s%d" % (a, ce.STATUS_STRINGS[int(status[j])],
                    p.epoch_ms + (int(inc[j]) - 1) * p.period_ms if inc[j] > 0 else 0)
        for j, a in enumerate(bat.universe.addresses) if known[j])


def batched_headline(mode: str, b: int, window: int = CHURN_TICKS) -> dict:
    """``BatchedSimClusters(b, n=1024)`` with the headline params: bootstrap,
    quiet ticks until every cluster converged, then a timed churn window
    and a timed quiet window; aggregate node-ticks/s, ms/tick, launches
    and host reads a tick and the busy share (a profiled churn window of
    ``PROFILE_TICKS``), peak memory; then one tick whose batching-rule
    calls are held against the plain versions (:class:`_RuleCapture`)."""
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim.batched import BatchedSimClusters
    from ringpop_tpu_torch.models.sim.cluster import EventSchedule
    from ringpop_tpu_torch.ops import farmhash32

    n = N_HEAD
    torch.cuda.reset_peak_memory_stats()
    bat = BatchedSimClusters(b, n, params=engine.SimParams(n=n, checksum_mode=mode), device="cuda")
    t0 = time.perf_counter()
    bat.bootstrap()
    quiet1 = EventSchedule(ticks=1, n=n)
    converged_in = -1
    for t in range(96):
        if bool(bat.run(quiet1).converged.all()) and t >= 1:
            converged_in = t + 1
            break
    if converged_in < 0:
        raise AssertionError("batched %s b=%d: not converged within 96 ticks" % (mode, b))
    converge_s = time.perf_counter() - t0
    out = dict(mode=mode, b=b, n=n, converged_in=converged_in, converge_s=converge_s)
    for label, sched in (("churn", EventSchedule.churn_window(window, n)),
                         ("quiet", EventSchedule(ticks=window, n=n))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = bat.run(sched)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[label] = dict(ticks=window, wall_s=wall, ms_per_tick=wall / window * 1e3,
                          node_ticks_per_s=b * n * window / wall)
    if not (bool(m.converged[-1].all()) and _one_group_per_cluster(bat)):
        raise AssertionError("batched %s b=%d: not one checksum group per cluster" % (mode, b))
    t0 = time.perf_counter()
    out["profile"] = _profile_window(
        lambda: bat.run(EventSchedule.churn_window(PROFILE_TICKS, n)), PROFILE_TICKS, "cuda")
    out["profile_s"] = time.perf_counter() - t0
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # one tick more with every batching rule's operands and results kept:
    # each kernel held against its plain version at this path's shapes
    # (a straight-line tick calls every rule, with the same shapes, each
    # tick)
    t0 = time.perf_counter()
    with _RuleCapture() as cap:
        bat.run(EventSchedule(ticks=1, n=n))
    out["held_plain"] = _check_rule_capture(cap.kept, "batched %s b=%d" % (mode, b))
    del cap
    out["held_plain_s"] = time.perf_counter() - t0
    if mode == "farmhash":
        want = farmhash32.hash32(_checksum_string(bat, 0, 0))
        got = int(bat.checksums()[0, 0])
        if got != want:
            raise AssertionError("batched: node 0 checksum %#x != host farmhash32 %#x"
                                 % (got, want))
        out["node0_checksum"] = "%#010x" % got
    print("batched %s" % json.dumps(out), flush=True)
    return out


def batched_paths() -> list:
    """The batched n=1024 main path: fast at B in (1, 8, 32), farmhash at
    B in (1, 8)."""
    return [batched_headline(mode, b) for mode, b in
            (("fast", 1), ("fast", 8), ("fast", 32), ("farmhash", 1), ("farmhash", 8))]


def fuzz_throughput() -> dict:
    """The JAX slow tier's wide sweep on the card: 640 full scenarios (n=8,
    24 ticks, loss 0 / 0.05 / 0.2) and 384 scalable ones (n=32), zero
    violations required; scenarios/s of the batched runs and with the host
    checks, and launches per batched tick (one loss bucket's batch profiled
    over runs of ``PROFILE_TICKS`` and twice as many ticks)."""
    from ringpop_tpu_torch.fuzz import executor as fex
    from ringpop_tpu_torch.fuzz import invariants as inv
    from ringpop_tpu_torch.fuzz import scenarios as sc

    out = {}
    for kw, count in ((FUZZ_FULL, 640), (FUZZ_SCALABLE, 384)):
        cfg = sc.ScenarioConfig(**kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs = fex.sweep(list(range(count)), cfg, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bad = {r.seeds[i]: vs for r in runs for i, vs in inv.check_run(r).items()}
        check_s = time.perf_counter() - t0
        if bad:
            raise AssertionError("fuzz sweep %s: violations %s" % (cfg.engine, bad))
        first = runs[0]
        held = None
        if cfg.engine == "full":
            # the first bucket as the sweep ran it through the kernels (B
            # instances a launch) equals the same bucket run with the plain
            # versions on the card: final states, metrics and streams
            plain = fex.FullFuzzExecutor(cfg, params=first.params._replace(fused_tick="plain"),
                                         device="cuda").run_seeds(first.seeds)
            _fuzz_runs_equal([plain], [first], "fuzz sweep full B=%d plain" % len(first.seeds))
            held = len(first.seeds)
        # a batched tick's launches and host reads: the first bucket's batch
        # run under the profiler with its scenarios cut to PROFILE_TICKS
        # and to twice that, the difference over PROFILE_TICKS (the run's
        # set-up and drain cancel; a straight-line tick issues the same
        # launches whatever its schedule)
        profs = []
        for ticks in (PROFILE_TICKS, 2 * PROFILE_TICKS):
            ex = fex.executor_for(cfg._replace(ticks=ticks), packet_loss=first.params.packet_loss,
                                  device="cuda")
            profs.append(_profile_window(lambda: ex.run_seeds(first.seeds), ticks, "cuda"))
        prof = {k: (2 * profs[1][k] - profs[0][k]) for k in ("launches_per_tick",
                                                             "host_reads_per_tick")}
        prof["busy_share"] = profs[1]["busy_share"]
        out[cfg.engine] = dict(
            scenarios=count, n=cfg.n, ticks=cfg.ticks, batches=[len(r.seeds) for r in runs],
            run_s=run_s, check_s=check_s, scenarios_per_s=count / run_s,
            scenarios_per_s_with_checks=count / (run_s + check_s),
            launches_per_batched_tick=prof["launches_per_tick"],
            host_reads_per_batched_tick=prof["host_reads_per_tick"],
            busy_share=prof["busy_share"], violations=0, held_plain_instances=held,
        )
    print("fuzz %s" % json.dumps(out), flush=True)
    return out



# ---------------------------------------------------------------------------
# checkpoints and recovery (models/sim/checkpoint.py, recovery.py, fuzz/crash.py)


def _metrics_close(got, want, label: str, mean: bool = True):
    """The storm's metric rule: every field bitwise, the float32
    ``mean_heard_frac`` included; returns the ticks where
    ``mean_heard_frac`` is not bitwise (0, or this raises).  ``mean=False``
    (a mesh against the single device) leaves ``mean_heard_frac`` out and
    returns None: the mesh sums it in JAX's node-sharded order, which
    rounds otherwise by design (tests/test_torch_mesh.py), and it is held
    bitwise against the mesh on the CPU instead."""
    import numpy as np

    if not mean:
        want = want._replace(mean_heard_frac=got.mean_heard_frac)
    for f in want._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if a.shape != b.shape:
            raise AssertionError("%s: metric %s shape %r vs %r" % (label, f, a.shape, b.shape))
        if f != "mean_heard_frac" and not np.array_equal(a, b):
            raise AssertionError("%s: metric %s differs" % (label, f))
    if not mean:
        return None
    inexact = int((np.asarray(got.mean_heard_frac) != np.asarray(want.mean_heard_frac)).sum())
    _no_inexact(inexact, label)
    return inexact


def _scalable_metrics_same(got, want, label: str) -> int:
    """One tick's ScalableMetrics: integers bitwise (raises), and 1 if
    ``mean_heard_frac`` is not bitwise (the caller counts those ticks and
    raises on any with :func:`_no_inexact`), else 0."""
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    for f in es.ScalableMetrics._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f != "mean_heard_frac" and a != b:
            raise AssertionError("%s: metric %s %r vs %r" % (label, f, a, b))
    return int(got.mean_heard_frac != want.mean_heard_frac)


def _no_inexact(ticks: int, label: str) -> None:
    if ticks:
        raise AssertionError("%s: mean_heard_frac not bitwise on %d ticks" % (label, ticks))


def _arrays_same(got: dict, want: dict, label: str) -> None:
    import numpy as np

    if sorted(got) != sorted(want):
        raise AssertionError("%s: fields %r vs %r" % (label, sorted(got), sorted(want)))
    for f in want:
        a, b = got[f], want[f]
        if (a is None) != (b is None) or (
            a is not None and (a.dtype != b.dtype or not np.array_equal(a, b))
        ):
            raise AssertionError("%s: %s differs" % (label, f))


def check_ckpt_e2e(n=N_MID, ticks=40):
    """Phase 4, checkpoints: the n=4096 storm saved on the card at tick 20
    (a manifest, shards=2), restored on the CPU and on a fresh card, both
    run to tick 40 equal to the card's uninterrupted run; a farmhash
    ``SimCluster(n=64)`` with the fused tick and the flight recorder saved
    mid-churn, its record cache rebuilt equal, resumed through
    ``fused_stream``; the crash harness for the three drivers on the card."""
    import shutil
    import tempfile

    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.fuzz import crash
    from ringpop_tpu_torch.fuzz.scenarios import CrashPlan, ScenarioConfig, crash_plan_of
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.cluster import SimCluster
    from ringpop_tpu_torch.models.sim.recovery import concat_metrics
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster
    from ringpop_tpu_torch.ops import stream_hash

    root = tempfile.mkdtemp(prefix="ckpt_e2e_")
    try:
        # card -> CPU -> card
        params = es.ScalableParams(n=n, u=512, packet_loss=0.05, suspicion_ticks=5)
        sched = _mid_storm_schedule(n, ticks)
        half = ticks // 2
        twin = ScalableCluster(n=n, params=params, seed=2, device="cuda")
        m_twin = twin.run(sched)
        want = convert.state_arrays(twin.state)
        victim = ScalableCluster(n=n, params=params, seed=2, device="cuda")
        m_head = victim.run(sched.window(0, half))
        victim.enable_checkpoints(os.path.join(root, "storm"), shards=2)
        path = victim.checkpoint_now()
        del victim
        inexact = {}
        for dev in ("cpu", "cuda"):
            back = ScalableCluster(n=n, params=params, seed=7, device=dev)
            back.enable_checkpoints(os.path.join(root, "storm"), shards=2)
            if back.restore_latest() != half:
                raise AssertionError("n=%d storm: %s restore did not resume at %d" % (n, dev, half))
            m_tail = back.run(sched.window(half, ticks))
            label = "n=%d storm card -> %s -> tick %d" % (n, dev, ticks)
            _arrays_same(convert.state_arrays(back.state), want, label)
            inexact[dev] = _metrics_close(concat_metrics([m_head, m_tail]), m_twin, label)
        print("ckpt n=%d storm: saved on the card at tick %d (%s, shards=2), resumed on the cpu "
              "and the card to tick %d: every state field == the uninterrupted card run, metrics "
              "equal (mean_heard_frac not bitwise on %s ticks)"
              % (n, half, os.path.basename(path), ticks, json.dumps(inexact)), flush=True)

        # farmhash SimCluster: the record cache rebuilt, then hashed
        sn, st = 64, 32
        p = engine.SimParams(n=sn, checksum_mode="farmhash", suspicion_ticks=6,
                             flight_recorder=True)
        sched = _churn_schedule(sn, st)
        twin = SimCluster(n=sn, params=p, seed=1, device="cuda")
        assert twin.params.fused_tick == "kernel" and twin.params.fused_checksum == "on"
        twin.bootstrap()
        twin.run(sched)
        want = convert.state_arrays(twin.state)
        victim = SimCluster(n=sn, params=p, seed=1, device="cuda")
        victim.bootstrap()
        victim.run(sched.window(0, st // 2))
        legacy = os.path.join(root, "sim.npz")
        victim.save(legacy)
        for dev in ("cpu", "cuda"):
            back = SimCluster(n=sn, params=p, seed=5, device=dev)
            back.load(legacy)
            for f in ("rec_bytes", "rec_len"):
                if not torch.equal(getattr(back.state, f).cpu(), getattr(victim.state, f).cpu()):
                    raise AssertionError("farmhash restore on %s: rebuilt %s != the saved run's"
                                         % (dev, f))
            launches0 = stream_hash.fused_stream.launches
            back.run(sched.window(st // 2, st))
            fired = stream_hash.fused_stream.launches - launches0
            if dev == "cuda" and fired == 0:
                raise AssertionError("farmhash restore: fused_stream never launched after it")
            _arrays_same(convert.state_arrays(back.state), want,
                         "farmhash n=%d restore on %s" % (sn, dev))
        print("ckpt farmhash n=%d: legacy save at tick %d, record cache rebuilt == saved, "
              "resumed on the cpu and the card (%d fused_stream launches after the restore): "
              "every state field == the uninterrupted run" % (sn, st // 2 + 1, fired), flush=True)

        # the crash harness, three drivers on the card
        cfg = ScenarioConfig(n=64, ticks=12)
        reports = {}
        for drv in crash.DRIVERS:
            runs = [(seed, None) for seed in (1, 7, 8)]
            runs.append((5, CrashPlan(kill_tick=8, corrupt="torn-manifest", frac=0.5)))
            for seed, plan in runs:
                r = crash.run_crash_resume(seed, root, driver=drv, config=cfg, every=3,
                                           plan=plan, device="cuda")
                label = "crash %s seed %d" % (drv, seed)
                if r.violations:
                    raise AssertionError("%s: %s" % (label, r.violations[0].message))
                damaged = (plan or crash_plan_of(seed, crash.schedule_config(drv, cfg))).corrupt
                if damaged != "none" and not r.skipped_errors:
                    raise AssertionError("%s: the damaged newest checkpoint was not skipped"
                                         % label)
                if plan is not None and (r.resumed_tick != 6
                                         or "CheckpointTornError" not in r.skipped_errors):
                    raise AssertionError("%s: forced torn-manifest resumed at %r past %r"
                                         % (label, r.resumed_tick, r.skipped_errors))
                reports["%s/%d" % (drv, seed)] = dict(
                    kill=r.kill_tick, corrupt=r.corrupt, resumed=r.resumed_tick,
                    skipped=list(r.skipped_errors))
        print("ckpt crash harness on the card (n=64, 12 ticks, every=3): no violation %s"
              % json.dumps(reports), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _kept_saves(mgr) -> list:
    """Keep a copy of ``mgr.last_save`` (the split seconds) after every
    save the manager makes; returns the list it fills."""
    saves, save_call = [], mgr.save

    def save(tick, states, meta=None):
        out = save_call(tick, states, meta)
        saves.append(dict(mgr.last_save))
        return out

    mgr.save = save
    return saves


def _ckpt_storm_1m() -> dict:
    """The 1M storm killed mid-save: a cadenced victim (every=20, keep=2)
    runs to tick 45, its forced tick-45 save is torn, a cold restart skips
    it and resumes at 40, and ticks 40-60 land bitwise on the warm run."""
    import shutil
    import tempfile

    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.fuzz.crash import corrupt_checkpoint
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster
    from ringpop_tpu_torch.ops import exchange as ex

    if not STORM_WARM:
        raise AssertionError("the checkpointed storm needs the 1M storm path's warm twin")
    n, ticks, every, kill = N_STORM, STORM_TICKS, 20, 45
    params, sched = _storm_config()
    twin = STORM_WARM["out"]
    root = tempfile.mkdtemp(prefix="ckpt_1m_")
    try:
        victim = ScalableCluster(n=n, params=params, seed=STORM_WARM["seed"], device="cuda")
        saves = _kept_saves(victim.enable_checkpoints(root, every=every, keep=2))
        torch.cuda.synchronize()
        launches0, reads0 = ex.exchange.launches, es.host_read.count
        t0 = time.perf_counter()
        victim.run(sched.window(0, kill))
        torch.cuda.synchronize()
        victim_wall = time.perf_counter() - t0
        victim_reads = es.host_read.count - reads0
        torn = victim.checkpoint_now()
        nbytes = sum(os.path.getsize(os.path.join(torn, f)) for f in os.listdir(torn))
        manifest_nbytes = saves[-1]["nbytes"]
        corrupt_checkpoint(torn, "torn-array", 0.5)
        del victim

        back = ScalableCluster(n=n, params=params, seed=STORM_WARM["seed"], device="cuda")
        mgr = back.enable_checkpoints(root, every=every, keep=2)
        tail_saves = _kept_saves(mgr)
        t0 = time.perf_counter()
        resumed = back.restore_latest()
        restore_wall = time.perf_counter() - t0
        skipped = [(t, type(e).__name__) for t, _, e in mgr.last_errors]
        if resumed != 40 or skipped != [(kill, "CheckpointTornError")]:
            raise AssertionError("1M restore resumed at %r past %r" % (resumed, skipped))
        reads1 = es.host_read.count
        t0 = time.perf_counter()
        metrics = back.run(sched.window(resumed, ticks))
        torch.cuda.synchronize()
        tail_wall = time.perf_counter() - t0
        tail_reads = es.host_read.count - reads1
        launches = ex.exchange.launches - launches0
        driven = kill + ticks - resumed
        if launches != driven:
            raise AssertionError("1M checkpointed: %d exchange launches in %d ticks"
                                 % (launches, driven))
        _arrays_same(convert.state_arrays(back.state), STORM_WARM["state"],
                     "1M storm resumed at %d" % resumed)
        live = int(metrics.live_nodes[-1])
        if live != n:
            raise AssertionError("1M checkpointed: %d of %d nodes live" % (live, n))
        if not torch.equal(es.compute_checksums(back.state, back.params), back.state.checksum):
            raise AssertionError("1M checkpointed: incremental checksums != the full recompute")
        ring = "%#010x" % back.ring_checksum()
        if ring != twin["ring_checksum_after"]:
            raise AssertionError("1M checkpointed: ring digest %s != %s"
                                 % (ring, twin["ring_checksum_after"]))
        cadence_saves = [s for s in saves if s["tick"] % every == 0 and s["tick"] <= kill]
        save_wall = sum(s["wall_s"] for s in cadence_saves)
        out = dict(
            n=n, every=every, keep=2, kill_tick=kill, resumed_tick=resumed, skipped=skipped,
            checkpoint_bytes=nbytes, manifest_nbytes=manifest_nbytes,
            saves=[{k: s[k] for k in ("tick", "wall_s", "device_to_host_s", "serialise_crc_s",
                                      "write_fsync_s", "nbytes")} for s in saves],
            restore=dict(wall_s=restore_wall, scan_verify_s=mgr.last_restore["scan_verify_s"],
                         host_to_device_s=mgr.last_restore["install_s"]),
            victim_wall_s=victim_wall,
            victim_ms_per_tick_between_saves=(victim_wall - save_wall) / kill * 1e3,
            victim_ms_per_tick_with_saves=victim_wall / kill * 1e3,
            twin_ms_per_tick=twin["ms_per_tick"],
            resumed_ms_per_tick_between_saves=(
                tail_wall - sum(s["wall_s"] for s in tail_saves)) / (ticks - resumed) * 1e3,
            resumed_saves=[s["tick"] for s in tail_saves],
            host_syncs_per_tick_cadence_on=victim_reads / kill,
            save_transfers_per_tick_cadence_on=len(cadence_saves) / kill,
            host_syncs_per_tick_resumed=tail_reads / (ticks - resumed),
            host_syncs_per_tick_cadence_off=twin["host_syncs_per_tick"],
            exchange_launches=launches, ticks_driven=driven, ring_checksum=ring,
            bitwise_equal_to_twin=True,
        )
        print("ckpt %s" % json.dumps(out), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _ckpt_routed_100k() -> dict:
    """``RoutedStorm`` at bench.py's 100k (incremental ring): killed at
    tick 6 with the forced save's manifest torn, restored at 4 (every=4),
    equal to an uninterrupted twin in sim state, RouteCarry, truth ring
    and ring checksum."""
    import shutil
    import tempfile

    from ringpop_tpu_torch.fuzz import crash
    from ringpop_tpu_torch.models.route.plane import RoutedStorm, RouteParams
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import StormSchedule

    cfg = ROUTE_100K
    n, ticks, every, kill = cfg["n"], cfg["ticks"], 4, 6

    def build():
        return RoutedStorm(n, params=es.ScalableParams(n=n),
                           route=RouteParams(n=n, queries_per_tick=cfg["q"],
                                             ring_impl="incremental"),
                           seed=0, device="cuda")

    sched = StormSchedule.sparse_churn(ticks, n, cfg["churn"])
    twin = build()
    twin.run(sched)
    want, want_ring = crash.snapshot(crash.ROUTED, twin), twin.ring_checksum()
    del twin
    root = tempfile.mkdtemp(prefix="ckpt_route_")
    try:
        victim = build()
        victim.enable_checkpoints(root, every=every)
        victim.run(sched.window(0, kill))
        crash.corrupt_checkpoint(victim.checkpoint_now(), "torn-manifest", 0.5)
        del victim
        back = build()
        mgr = back.enable_checkpoints(root, every=every)
        t0 = time.perf_counter()
        resumed = back.restore_latest()
        torch.cuda.synchronize()
        restore_wall = time.perf_counter() - t0
        skipped = [type(e).__name__ for _, _, e in mgr.last_errors]
        if resumed != every or skipped != ["CheckpointTornError"]:
            raise AssertionError("routed 100k restore resumed at %r past %r" % (resumed, skipped))
        back.run(sched.window(resumed, ticks))
        _arrays_same(crash.snapshot(crash.ROUTED, back), want, "routed n=%d resumed" % n)
        if back.ring_checksum() != want_ring:
            raise AssertionError("routed n=%d resumed: ring checksum differs" % n)
        out = dict(n=n, q=cfg["q"], ticks=ticks, every=every, kill_tick=kill,
                   resumed_tick=resumed, skipped=skipped, restore_wall_s=restore_wall,
                   ring_checksum="%#010x" % want_ring, bitwise_equal_to_twin=True)
        print("ckpt_routed %s" % json.dumps(out), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def ckpt_paths() -> dict:
    """The checkpointed main paths: the 1M storm killed mid-save and the
    routed 100k storm killed after a torn manifest."""
    return dict(storm_1m=_ckpt_storm_1m(), routed_100k=_ckpt_routed_100k())


# ---------------------------------------------------------------------------
# the shard mesh (parallel/mesh.py): ShardedStorm on make_mesh(4)

MESH_SHARDS = 4
RING_1M = "0x29292e35"  # the 1M storm's ring digest with every node live
# the exchange calls of the mesh storm whose operands are kept (one call a
# shard a tick): tick 4 shard 0, tick 32 shard 1
MESH_CAPTURE_CALLS = (4 * MESH_SHARDS, 32 * MESH_SHARDS + 1)
MESH_CAPTURED = {}


def _trajectory_same(got, want, label: str) -> None:
    """Every trajectory field of two ScalableStates bitwise (the obs
    planes apart: a restore under another shard count re-zeroes them)."""
    import numpy as np

    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    a, b = convert.scalable_state_to_numpy(got), convert.scalable_state_to_numpy(want)
    for f in sorted(es.SCALABLE_TRAJECTORY_FIELDS):
        if not np.array_equal(a[f], b[f]):
            raise AssertionError("%s: state %s differs" % (label, f))


def check_mesh_e2e(n=N_MID, ticks=40, device="cuda", planes=False):
    """Phase 4, the shard mesh: the n=4096 storm of the storm phase on
    ``make_mesh(4)`` on the card equals the same mesh on the CPU and the
    single-device cluster on the card — every state field bitwise, every
    metric equal, ``mean_heard_frac`` bitwise too (the ticks where it is
    not are counted, and must be 0) — and so does the card mesh
    with the all-to-all cap forced to 1 (every route on the all-gather
    fallback).  ``planes``: with ``wavefront``, ``histograms`` and
    ``exchange_metrics=4`` on (the forced cap's run is held on every field
    but the exchange counters, which count its fallbacks)."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster
    from ringpop_tpu_torch.parallel import mesh as pmesh

    params = es.ScalableParams(n=n, u=512, packet_loss=0.05, suspicion_ticks=5,
                               wavefront=planes, histograms=planes,
                               exchange_metrics=MESH_SHARDS if planes else 0)
    sched = _mid_storm_schedule(n, ticks)
    card = pmesh.ShardedStorm(n, mesh=pmesh.make_mesh(MESH_SHARDS, device=device), params=params,
                              seed=2)
    cpu = pmesh.ShardedStorm(n, mesh=pmesh.make_mesh(MESH_SHARDS, device="cpu"), params=params,
                             seed=2)
    single = ScalableCluster(n=n, params=params, seed=2, device=device)
    if (card.exchange_mode, card.exchange_impl, cpu.exchange_impl) != ("shard_map", "kernel",
                                                                         "plain"):
        raise AssertionError("mesh resolution %r / %r" % (card.exchange_resolution(),
                                                          cpu.exchange_resolution()))
    m_card, m_cpu, m_single = card.run(sched), cpu.run(sched), single.run(sched)
    inexact = {"cpu mesh": _metrics_close(m_card, m_cpu, "n=%d mesh card vs cpu" % n),
               "card single": _metrics_close(m_card, m_single, "n=%d mesh vs single" % n,
                                             mean=False)}
    _arrays_same(convert.scalable_state_to_numpy(card.state),
                 convert.scalable_state_to_numpy(cpu.state), "n=%d mesh card vs cpu" % n)
    _arrays_same(convert.scalable_state_to_numpy(card.state),
                 convert.scalable_state_to_numpy(single.state), "n=%d mesh vs single" % n)
    forced = pmesh.ShardedStorm(n, mesh=pmesh.make_mesh(MESH_SHARDS, device=device),
                                params=params, seed=2, exchange_cap_override=1)
    inexact["cap=1"] = _metrics_close(forced.run(sched), m_card, "n=%d mesh cap=1" % n)
    got, want = (convert.scalable_state_to_numpy(x.state) for x in (forced, card))
    if planes:
        for f in ("exch", "exch_hist"):
            got.pop(f), want.pop(f)
    _arrays_same(got, want, "n=%d mesh cap=1" % n)
    if forced.comm.calls["all_to_all"] or not card.comm.calls["all_to_all"]:
        raise AssertionError("mesh routes: cap=1 ran %d all-to-alls, the default cap %d"
                             % (forced.comm.calls["all_to_all"], card.comm.calls["all_to_all"]))
    print("n=%d storm on make_mesh(%d) %s%s: %d ticks, every state field == the CPU mesh and "
          "the card's single-device cluster, metrics equal (mean_heard_frac, in the sharded "
          "order, not bitwise on %s ticks; None: not compared with the single device); "
          "cap=1 (all-gather fallback on every route) bitwise too"
          % (n, MESH_SHARDS, card.exchange_resolution()["devices"],
             " with wavefront, histograms, exchange_metrics=4" if planes else "", ticks,
             json.dumps(inexact)), flush=True)


def check_mesh_planes_e2e():
    """:func:`check_mesh_e2e` with the storm's obs planes on."""
    check_mesh_e2e(planes=True)


def _mesh_run(mesh, params, sched, seed: int = 0, ckpt_dir=None, capture=None) -> tuple:
    """One ShardedStorm run of ``sched`` on ``mesh``: the storm, its metrics
    and its numbers (wall, ms a tick, host reads a tick, exchange launches,
    collectives and routed bytes a tick, peak memory)."""
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.ops import exchange as ex
    from ringpop_tpu_torch.parallel import mesh as pmesh

    storm = pmesh.ShardedStorm(params.n, mesh=mesh, params=params, seed=seed)
    if ckpt_dir is not None:
        storm.enable_checkpoints(ckpt_dir, every=20, keep=3)
    cuda = storm.device.type == "cuda"
    _sync(storm.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    launches0, reads0 = ex.exchange.launches, es.host_read.count
    kernel = ex.exchange
    if capture is not None:
        ex.exchange = capture
    try:
        t0 = time.perf_counter()
        metrics = storm.run(sched)
        _sync(storm.device)
        wall = time.perf_counter() - t0
    finally:
        ex.exchange = kernel
    ticks = sched.ticks
    out = dict(
        devices=storm.exchange_resolution()["devices"],
        wall_s=wall,
        ms_per_tick=wall / ticks * 1e3,
        host_reads_per_tick=(es.host_read.count - reads0) / ticks,
        exchange_launches=ex.exchange.launches - launches0,
        collectives_per_tick={k: v / ticks for k, v in sorted(storm.comm.calls.items())},
        routes_per_tick=storm.comm.calls["all_to_all"] / 2 / ticks,
        routed_bytes_per_tick=storm.comm.a2a_bytes / ticks,
        gathered_bytes_per_tick=storm.comm.gather_bytes / ticks,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
    )
    return storm, metrics, out


def mesh_headline(n: int = N_STORM, ticks: int = STORM_TICKS, device="cuda",
                  ring: str = RING_1M) -> dict:
    """The 1M churn storm (``_storm_config``) on a 4-shard mesh beside its
    single-device twin: (b) a cold run with ``exchange_metrics=4`` and a
    timed warm run; 4 ``exchange`` launches a tick, the final state
    bitwise the twin's, every node live, the ring digest, the drained
    exchange totals equal to the twin's, routed bytes a tick against the
    traffic model; on a machine with 4 cards the warm run again on
    cuda:0..3; (c) the cold run's tick-20 checkpoint (4 shard files)
    restored on 1 and 2 shards and run to tick 60, bitwise; then launches
    and host reads a tick of the fail window under the profiler, mesh and
    single device."""
    import shutil
    import tempfile

    import numpy as np

    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
    from ringpop_tpu_torch.ops import exchange as ex
    from ringpop_tpu_torch.parallel import mesh as pmesh

    shards = MESH_SHARDS
    params = es.ScalableParams(n=n, u=512, checksum_in_tick=True)
    sched = StormSchedule.churn_storm(ticks, n, fraction=0.10, fail_tick=2, seed=0)
    metered = params._replace(exchange_metrics=shards)
    cuda = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if cuda else 1
    card0 = torch.device("cuda", 0) if cuda else torch.device("cpu")
    one_card = pmesh.make_mesh(devices=[card0] * shards)
    # the single-device twin, with the exchange telemetry's analytic model
    twin = ScalableCluster(n=n, params=metered, seed=0, device=card0)
    _sync(card0)
    launches0, reads0 = ex.exchange.launches, es.host_read.count
    t0 = time.perf_counter()
    m_twin = twin.run(sched)
    _sync(card0)
    twin_out = dict(wall_s=time.perf_counter() - t0,
                    host_reads_per_tick=(es.host_read.count - reads0) / ticks,
                    exchange_launches=ex.exchange.launches - launches0)
    twin_out["ms_per_tick"] = twin_out["wall_s"] / ticks * 1e3
    twin_drain = twin.drain_exchange_metrics(reset=False)
    root = tempfile.mkdtemp(prefix="mesh_1m_")
    try:
        # (b) cold, metered and checkpointed every 20 ticks
        cold, m_cold, cold_out = _mesh_run(one_card, metered, sched, ckpt_dir=root)
        drain = cold.drain_exchange_metrics(reset=False)
        if drain["totals"] != twin_drain["totals"]:
            raise AssertionError("mesh 1M: drained totals %r != the twin's %r"
                                 % (drain["totals"], twin_drain["totals"]))
        _metrics_close(m_cold, m_twin, "mesh 1M cold vs twin", mean=False)
        _trajectory_same(cold.state, twin.state, "mesh 1M cold vs twin")
        # warm, timed, the exchange operands of two shard calls kept
        capture = _ExchangeCapture(ex.exchange, MESH_CAPTURE_CALLS)
        warm, m_warm, warm_out = _mesh_run(one_card, params, sched, capture=capture)
        MESH_CAPTURED.update(capture.kept)
        runs = {"one card": warm_out}
        for label, storm, m, out in (("cold", cold, m_cold, cold_out),
                                     ("warm", warm, m_warm, warm_out)):
            if out["exchange_launches"] != shards * ticks:
                raise AssertionError("mesh 1M %s: %d exchange launches in %d ticks of %d shards"
                                     % (label, out["exchange_launches"], ticks, shards))
            if int(m.live_nodes[-1]) != n:
                raise AssertionError("mesh 1M %s: %d of %d nodes live" % (label, int(m.live_nodes[-1]), n))
            digest = "%#010x" % storm.ring_checksum()
            if digest != ring:
                raise AssertionError("mesh 1M %s: ring digest %s, not %s" % (label, digest, ring))
            out["ring_checksum"] = digest
        _metrics_close(m_warm, m_twin, "mesh 1M warm vs twin", mean=False)
        _trajectory_same(warm.state, twin.state, "mesh 1M warm vs twin")
        st = warm.state
        if not torch.equal(es.compute_checksums(st, warm.params), st.checksum):
            raise AssertionError("mesh 1M: incremental checksums != the full recompute")
        # the all-to-all bytes: every route costs half the model's tick (one
        # direction); no route overflowed
        model = ex.cross_shard_traffic_bytes(n, params.u // 32, shards)
        routes = warm.comm.calls["all_to_all"] // 2
        if warm.comm.a2a_bytes != routes * model["interconnect_total"] // 2:
            raise AssertionError("mesh 1M: %d all-to-all bytes over %d routes, model %r"
                                 % (warm.comm.a2a_bytes, routes, model))
        if cuda and cards >= shards:
            spread = pmesh.make_mesh(shards)
            s_storm, s_m, s_out = _mesh_run(spread, params, sched)
            _trajectory_same(s_storm.state, twin.state, "mesh 1M on %d cards" % shards)
            _metrics_close(s_m, m_warm, "mesh 1M on %d cards vs one card" % shards)
            runs["%d cards" % shards] = s_out
            print("mesh 1M: also ran on %s" % s_out["devices"], flush=True)
            del s_storm
        else:
            print("mesh 1M: %d shards on cuda:0 (%d card%s visible)"
                  % (shards, cards, "" if cards == 1 else "s"), flush=True)
        # (c) the tick-20 checkpoint resumed on 1 and 2 shards, run to 60
        path = cold.checkpoint_manager.path_of(20)
        restored = {}
        for k in (1, 2):
            r = pmesh.ShardedStorm(n, mesh=pmesh.make_mesh(devices=[card0] * k), params=params,
                                   seed=9)
            t1 = time.perf_counter()
            r.load(path)
            _sync(card0)
            load_s = time.perf_counter() - t1
            m_r = r.run(sched.window(20, ticks))
            _metrics_close(m_r, es.ScalableMetrics(*(np.asarray(getattr(m_twin, f))[20:]
                                                     for f in es.ScalableMetrics._fields)),
                           "mesh 1M resumed on %d" % k, mean=k == 1)
            _trajectory_same(r.state, twin.state, "mesh 1M resumed on %d shard(s)" % k)
            restored["%d" % k] = dict(load_s=load_s)
            del r
        saved = cold.checkpoint_manager.last_save
        del cold
        # launches and host reads a tick: the fail window (ticks 0-5)
        window = StormSchedule(ticks=6, n=n, kill=sched.kill[:6], revive=sched.revive[:6])
        prof_storm = pmesh.ShardedStorm(n, mesh=one_card, params=params, seed=0)
        prof_single = ScalableCluster(n=n, params=params, seed=0, device=card0)
        profiled = {"mesh": _profile_window(lambda: prof_storm.run(window), window.ticks, card0,
                                            top=1 << 30),
                    "single": _profile_window(lambda: prof_single.run(window), window.ticks,
                                              card0)}
        # the shard tile's exchange time on the path itself, where the
        # kernels between two shards' launches have moved its operands out
        # of the L2
        tiles = [k for k in profiled["mesh"].pop("top") if "exchange_kernel" in k["name"]]
        tile_launches = sum(k["launches"] for k in tiles)
        profiled["mesh"]["exchange_on_path"] = dict(
            launches=tile_launches,
            device_ms_mean=sum(k["device_ms"] for k in tiles) / max(tile_launches, 1))
        del prof_storm, prof_single
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = dict(
        n=n, ticks=ticks, shards=shards, resolution=warm.exchange_resolution(),
        runs=runs, cold=cold_out, twin=twin_out,
        model_interconnect_bytes_per_route=model["interconnect_total"] // 2,
        traffic_model=model,
        drained_totals={k: drain["totals"][k] for k in ("ticks", "a2a_pull", "a2a_push",
                                                       "fallback_pull", "fallback_push",
                                                       "pull_rows", "push_rows",
                                                       "wire_bytes_pull", "wire_bytes_push")
                        if k in drain["totals"]},
        drained_totals_equal_twin=True, state_equal_twin=True,
        checkpoint=dict(tick=20, shard_files=shards, last_save=saved, resumed_on=restored),
        fail_window=profiled,
    )
    print("mesh storm %s" % json.dumps(out, default=str), flush=True)
    del warm
    return out


def mesh_planes_headline(n: int = N_STORM, ticks: int = STORM_TICKS, device="cuda") -> dict:
    """The planes-on 1M storm of ``storm_planes_headline`` (``wavefront``,
    ``histograms``, ``exchange_metrics=4``) on a 4-shard mesh of ``cuda:0``
    beside that path's single-device twin: 4 ``exchange`` launches a tick,
    the metrics the twin's (``mean_heard_frac`` apart: the sharded order),
    and ``first_heard``, ``hist`` and the ``scalable_wavefront_summary`` of
    the joined state bitwise the twin's; ms/tick and peak GiB of both."""
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import StormSchedule
    from ringpop_tpu_torch.obs import events as oe
    from ringpop_tpu_torch.parallel import mesh as pmesh

    twin = STORM_PLANES
    if "wave" not in twin:
        raise AssertionError("mesh planes: the 1M storm obs planes path has not run")
    params = es.ScalableParams(n=n, u=512, checksum_in_tick=True, wavefront=True,
                               histograms=True, exchange_metrics=MESH_SHARDS)
    sched = StormSchedule.churn_storm(ticks, n, fraction=0.10, fail_tick=2, seed=0)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    storm, metrics, run = _mesh_run(pmesh.make_mesh(devices=[dev] * MESH_SHARDS), params, sched)
    if dev.type == "cuda" and run["exchange_launches"] != MESH_SHARDS * ticks:
        raise AssertionError("mesh planes: %d exchange launches in %d ticks"
                             % (run["exchange_launches"], ticks))
    _metrics_close(metrics, twin["metrics"], "1M mesh planes vs twin", mean=False)
    st = storm.state
    for f in ("first_heard", "hist"):
        if not torch.equal(getattr(st, f), twin[f]):
            raise AssertionError("1M mesh planes: %s differs from the twin's" % f)
    t0 = time.perf_counter()
    host = {f: getattr(st, f).cpu().numpy() for f in ("first_heard", "r_birth", "r_active")}
    wave = oe.scalable_wavefront_summary(host["first_heard"], host["r_birth"], host["r_active"],
                                         st.proc_alive.cpu().numpy())
    summary_s = time.perf_counter() - t0
    if wave != twin["wave"] or not wave["rumors"]:
        raise AssertionError("1M mesh planes: the wavefront summary differs from the twin's")
    out = dict(n=n, ticks=ticks, shards=MESH_SHARDS, mesh=run,
               twin=dict(ms_per_tick=twin["ms_per_tick"], peak_mem_gib=twin["peak_mem_gib"]),
               first_heard_equal=True, hist_equal=True, wavefront_summary_equal=True,
               wavefront_rumors=len(wave["rumors"]), summary_s=summary_s,
               first_heard_shard_rows=[int(x.first_heard.shape[0]) for x in storm.shard_states])
    twin.clear()  # the twin's 2 GiB plane goes with it
    print("mesh storm planes %s" % json.dumps(out), flush=True)
    return out


def check_mesh_tile_operands(ex_report: dict) -> None:
    """(d) The kernel on one shard's own ``[N/S, U/32]`` operands, kept from
    the mesh storm's warm run, after the path's counts are read: equal to
    its plain version, timed with the L2 flushed before each call (a tile's
    64 MB of operands would otherwise be read largely from the 50 MB L2),
    with its byte bound and launch plan."""
    from ringpop_tpu_torch.ops import exchange as ex

    if sorted(MESH_CAPTURED) != list(MESH_CAPTURE_CALLS):
        raise AssertionError("kept the mesh storm's exchange calls %s, not %s"
                             % (sorted(MESH_CAPTURED), MESH_CAPTURE_CALLS))
    cases = {}
    for call, args in sorted(MESH_CAPTURED.items()):
        if tuple(args[0].shape) != (N_STORM // MESH_SHARDS, 16):
            raise AssertionError("mesh tile %r" % (tuple(args[0].shape),))
        _same(tuple(ex.exchange(*args)), tuple(ex.exchange_plain(*args)),
              "exchange shard tile, call %d" % call)
        label = "shard_tile_tick%d_shard%d" % divmod(call, MESH_SHARDS)
        cases[label] = _exchange_timed(ex, args, "1M mesh %s" % label, cold_l2=True)
    ex_report.setdefault("storm_operands", {}).update(cases)


# ---------------------------------------------------------------------------
# ShardedSim: the full engine on the shard mesh

SIM_MESH_BIG = 8192
SIM_MESH_BIG_TICKS = 32
SIM_PROFILE_TICKS = 8
# one shard-tile call of each kernel of the full tick, kept from the mesh
# paths: kernel -> (positional operands, keywords)
SIM_TILES = {}
SIM_TILE_ROWS = N_HEAD // MESH_SHARDS


class _TileCapture:
    """Stands in for one kernel wrapper (``module.name``) while a mesh path
    runs and keeps clones of the operands of the first call that ``want``
    picks (a shard tile).  The wrapper's body counts its launch on the
    module attribute, which is this object while it is bound: ``launches``
    reads and writes the wrapper's own count."""

    def __init__(self, module, name: str, want):
        self.module, self.name, self.want = module, name, want
        self.fn = getattr(module, name)
        self.kept = None

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False

    def __call__(self, *args, **kw):
        if self.kept is None and self.want(args, kw):
            self.kept = (_clone(args), dict(kw))
        return self.fn(*args, **kw)


def _tile_captures():
    """Captures of the n=1024 mesh's shard-tile calls: ``apply_updates`` at
    a shard past the first (``lo != 0``), ``pb_budget`` and
    ``fused_stream`` on a shard's rows."""
    from ringpop_tpu_torch.ops import fused_apply as fa
    from ringpop_tpu_torch.ops import fused_piggyback as fp
    from ringpop_tpu_torch.ops import stream_hash as sh

    tile = (SIM_TILE_ROWS, N_HEAD)
    return {
        "apply_updates": _TileCapture(fa, "apply_updates", lambda a, k: (
            k.get("lo", 0) != 0 and tuple(a[1].shape) == tile and k.get("want_masks"))),
        "pb_budget": _TileCapture(fp, "pb_budget", lambda a, k: tuple(a[1].shape) == tile),
        "fused_stream": _TileCapture(sh, "fused_stream",
                                     lambda a, k: a[3].shape[:2] == (SIM_TILE_ROWS, N_HEAD)),
    }


def _sim_fields_same(got, want, label: str) -> None:
    """Every SimState field (the uint32 ones as uint32) bitwise."""
    from ringpop_tpu_torch import convert

    _arrays_same(convert.state_to_numpy(got), convert.state_to_numpy(want), label)


def _tick_metrics_same(got, want, label: str) -> None:
    import numpy as np

    for f in got._fields:
        if not np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))):
            raise AssertionError("%s: metric %s differs" % (label, f))


def check_sharded_sim_e2e(n=64, full_ticks=32):
    """Phase 4, ``ShardedSim``: the n=64 churn schedule on ``make_mesh(4)``
    on the card equals the same mesh on the CPU and the card's
    ``SimCluster`` on every state and metric field of every tick, in fast,
    farmhash (the fused checksums) and classic (``fused_tick="off"``,
    ``fused_checksum="off"``: ``block_loop`` on each shard's rows), with
    the obs planes off and on (flight recorder and histograms: the event
    buffer's capacity blocks, heads, drops, first_heard and hist; half
    the ticks)."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim.cluster import SimCluster, _tick_at
    from ringpop_tpu_torch.ops import block_loop as bl
    from ringpop_tpu_torch.parallel import ShardedSim, make_mesh

    for mode, planes in ((m, o) for o in (False, True) for m in ("fast", "farmhash", "classic")):
        p = engine.SimParams(n=n, checksum_mode="fast" if mode == "fast" else "farmhash",
                             suspicion_ticks=6, flight_recorder=planes, histograms=planes)
        if mode == "classic":
            p = p._replace(fused_tick="off", fused_checksum="off")
        # the planes' pass runs half the schedule (every event of it still
        # falls inside): the CPU mesh is most of this check's time
        ticks = full_ticks // 2 if planes else full_ticks
        sims = [ShardedSim(n, make_mesh(MESH_SHARDS), params=p, seed=1),
                ShardedSim(n, make_mesh(MESH_SHARDS, device="cpu"), params=p, seed=1),
                SimCluster(n=n, params=p, seed=1, device="cuda")]
        note = sims[0].fused_tick_resolution()
        if mode != "classic" and (note["impl"], sims[1].params.fused_tick) != ("kernel", "plain"):
            raise AssertionError("mesh fused_tick resolution %r" % (note,))
        sched = _churn_schedule(n, ticks)
        ins = [sched.as_inputs(s.device) for s in sims]
        mesh_loops = 0

        def advance(t):
            nonlocal mesh_loops
            out = []
            for k, (s, i) in enumerate(zip(sims, ins)):
                l0 = bl.block_loop.launches
                out.append(s.bootstrap() if t < 0 else s.step(_tick_at(i, t)))
                if k == 0:
                    mesh_loops += bl.block_loop.launches - l0
            return out

        ms = advance(-1)
        for t in range(ticks + 1):
            label = "n=%d %s planes=%s mesh tick %d" % (n, mode, planes, t)
            for k, what in ((1, "the cpu mesh"), (2, "the card's SimCluster")):
                _tick_metrics_same(ms[0], ms[k], "%s vs %s" % (label, what))
                _sim_fields_same(sims[0].state, sims[k].state, "%s vs %s" % (label, what))
            if t < ticks:
                ms = advance(t)
        if mode == "classic" and not mesh_loops:
            raise AssertionError("n=%d classic mesh: block_loop never launched" % n)
        obs = ""
        if planes:
            st = sims[0].state
            obs = " (obs planes on: %d events, %d dropped, %d histogram observations)" % (
                int(st.ev_head), int(st.ev_drops),
                int(convert.state_to_numpy(st)["hist"].astype("int64").sum()))
        print("n=%d %s on make_mesh(%d) %s: %d ticks, every state and metric field == the CPU "
              "mesh and the card's SimCluster (block_loop launches on the mesh: %d)%s"
              % (n, mode, MESH_SHARDS, note["devices"], ticks + 1, mesh_loops, obs), flush=True)


def _sim_kernel_launches():
    from ringpop_tpu_torch.ops import block_loop, fused_apply, fused_piggyback, stream_hash

    return {"apply_updates": fused_apply.apply_updates.launches,
            "pb_budget": fused_piggyback.pb_budget.launches,
            "fused_stream": stream_hash.fused_stream.launches,
            "block_loop": block_loop.block_loop.launches}


def _sim_drive(sim, label: str) -> dict:
    """Bootstrap, ``run_until_converged(96, quiet_after=1)`` (7 ticks
    required) and a timed 256-tick quiet window (0 replays required): the
    numbers, with each kernel's launches a tick in the window."""
    import numpy as np

    from ringpop_tpu_torch.models.sim.cluster import EventSchedule

    dev = sim.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sim.bootstrap()
    converged_in = sim.run_until_converged(max_ticks=96, quiet_after=1)
    torch.cuda.synchronize(dev)
    converge_s = time.perf_counter() - t0
    if converged_in != 7:
        raise AssertionError("%s: converged in %d ticks, not 7" % (label, converged_in))
    replays0 = sim.parity_replays
    k0 = _sim_kernel_launches()
    comm = getattr(sim, "comm", None)
    if comm is not None:
        c0 = (dict(comm.calls), comm.fetch_bytes, comm.scatter_bytes, comm.gather_bytes)
    t0 = time.perf_counter()
    m = sim.run(EventSchedule(ticks=TICKS, n=sim.params.n))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    k1 = _sim_kernel_launches()
    if sim.parity_replays != replays0 or not bool(np.asarray(m.converged)[-1]):
        raise AssertionError("%s: %d replays in the window, converged %s"
                             % (label, sim.parity_replays - replays0, bool(m.converged[-1])))
    out = dict(converged_in=converged_in, converge_s=converge_s, window_s=wall,
               ms_per_tick=wall / TICKS * 1e3, node_ticks_per_s=sim.params.n * TICKS / wall,
               replays=sim.parity_replays - replays0,
               kernel_launches_per_tick={k: (k1[k] - k0[k]) / TICKS for k in k0},
               peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    if comm is not None:
        out["collectives_per_tick"] = {k: (v - c0[0].get(k, 0)) / TICKS
                                       for k, v in sorted(comm.calls.items())}
        out["bytes_per_tick"] = dict(fetch=(comm.fetch_bytes - c0[1]) / TICKS,
                                     scatter=(comm.scatter_bytes - c0[2]) / TICKS,
                                     gather=(comm.gather_bytes - c0[3]) / TICKS)
    return out


def _churn_profile(sim, ticks: int = SIM_PROFILE_TICKS) -> dict:
    """Launches, host reads, device ms a tick and busy share of a profiled
    churn window (``EventSchedule.churn_window``) run after the drive."""
    from ringpop_tpu_torch.models.sim.cluster import EventSchedule

    sched = EventSchedule.churn_window(ticks, sim.params.n)
    return _profile_window(lambda: sim.run(sched), ticks, sim.device)


def _kill_tick(sim, victims=(5, 300, 700)):
    """One tick that kills ``victims``: their pingers' rows turn dirty, so
    the checksums of converged (full-length) views are recomputed."""
    mask = torch.zeros(sim.params.n, dtype=torch.bool, device=sim.device)
    mask[list(victims)] = True
    return sim.step(sim.quiet_inputs()._replace(kill=mask))


def sharded_sim_headline(mode: str) -> dict:
    """``ShardedSim(1024, make_mesh(4))`` at the headline params (all four
    shards on ``cuda:0``) beside its ``SimCluster`` twin in the same call:
    ``_sim_drive`` on both, the final states bitwise equal, then a profiled
    churn window on both (launches and host reads a tick, busy share).  On
    a machine with two or more cards the mesh again round-robin over them,
    bitwise the one-card mesh; with one card a line says so.  In farmhash mode one more
    tick on the converged mesh keeps each kernel's first shard-tile call."""
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim.cluster import SimCluster
    from ringpop_tpu_torch.parallel import ShardedSim, make_mesh

    p = engine.SimParams(n=N_HEAD, checksum_mode=mode)
    card0 = torch.device("cuda", 0)
    twin = SimCluster(n=N_HEAD, params=p, device=card0)
    mesh = ShardedSim(N_HEAD, make_mesh(devices=[card0] * MESH_SHARDS), params=p)
    runs = {"twin": _sim_drive(twin, "n=1024 %s twin" % mode),
            "mesh": _sim_drive(mesh, "n=1024 %s mesh" % mode)}
    _sim_fields_same(mesh.state, twin.state, "n=1024 %s mesh vs twin" % mode)
    cards = torch.cuda.device_count()
    if cards >= 2:
        # round-robin: shard s on cuda:(s % cards)
        spread = ShardedSim(N_HEAD, make_mesh(MESH_SHARDS), params=p)
        runs["mesh on %d cards" % cards] = _sim_drive(spread, "n=1024 %s spread" % mode)
        _sim_fields_same(spread.state, mesh.state, "n=1024 %s mesh on %d cards" % (mode, cards))
        del spread
    else:
        print("n=1024 %s mesh: %d shards on cuda:0 (%d card%s visible: no multi-card run)"
              % (mode, MESH_SHARDS, cards, "" if cards == 1 else "s"), flush=True)
    profiled = {"mesh": _churn_profile(mesh), "twin": _churn_profile(twin)}
    _sim_fields_same(mesh.state, twin.state, "n=1024 %s mesh vs twin after churn" % mode)
    if mode == "farmhash":
        captures = _tile_captures()
        for c in captures.values():
            c.__enter__()
        try:
            _kill_tick(mesh)
        finally:
            for c in captures.values():
                c.__exit__()
        for name, c in captures.items():
            if c.kept is None:
                raise AssertionError("n=1024 mesh: no shard-tile call of %s was kept" % name)
            SIM_TILES[name] = c.kept
    out = dict(mode=mode, n=N_HEAD, shards=MESH_SHARDS, ticks=TICKS,
               resolution=mesh.fused_tick_resolution(), runs=runs, churn_window=profiled,
               state_equal_twin=True)
    print("sharded sim %s" % json.dumps(out, default=str), flush=True)
    return out


def sharded_sim_classic_tile() -> dict:
    """The classic configuration on the n=1024 mesh beside its twin:
    bootstrap, ``run_until_converged`` and one tick that kills three nodes
    (the gated recompute hashes the dirty rows' full-length strings in
    256-row chunks), ``block_loop``'s first shard-tile call of that tick
    kept, the state bitwise the twin's."""
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim.cluster import SimCluster
    from ringpop_tpu_torch.ops import block_loop as bl
    from ringpop_tpu_torch.parallel import ShardedSim, make_mesh

    p = engine.SimParams(n=N_HEAD, checksum_mode="farmhash", fused_tick="off",
                         fused_checksum="off")
    twin = SimCluster(n=N_HEAD, params=p, device="cuda")
    mesh = ShardedSim(N_HEAD, make_mesh(devices=[torch.device("cuda", 0)] * MESH_SHARDS),
                      params=p)
    converged = {}
    for label, sim in (("twin", twin), ("mesh", mesh)):
        sim.bootstrap()
        converged[label] = sim.run_until_converged(max_ticks=96, quiet_after=1)
        with _TileCapture(bl, "block_loop", lambda a, k: a[3].shape[0] == SIM_TILE_ROWS) as cap:
            _kill_tick(sim)
    if cap.kept is None:
        raise AssertionError("classic n=1024 mesh: no 256-row block_loop call was kept")
    SIM_TILES["block_loop"] = cap.kept
    _sim_fields_same(mesh.state, twin.state, "classic n=1024 mesh vs twin")
    if converged["mesh"] != converged["twin"]:
        raise AssertionError("classic n=1024: converged in %r" % converged)
    return dict(converged_in=converged["mesh"], block_loop_rows=SIM_TILE_ROWS,
                state_equal_twin=True)


def sharded_sim_big(n: int = SIM_MESH_BIG, ticks: int = SIM_MESH_BIG_TICKS) -> dict:
    """``ShardedSim(8192, make_mesh(4))`` in fast mode beside its twin:
    bootstrap, then a ``ticks``-tick churn window, timed; the final state
    bitwise the twin's; ms a tick, the shard state's GiB and the card's
    peak GiB (all four shards share ``cuda:0``)."""
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
    from ringpop_tpu_torch.parallel import ShardedSim, make_mesh

    p = engine.SimParams(n=n, checksum_mode="fast")
    sched = EventSchedule.churn_window(ticks, n)
    card0 = torch.device("cuda", 0)
    out = dict(n=n, ticks=ticks, shards=MESH_SHARDS)
    sims = {}
    for label, make in (("twin", lambda: SimCluster(n=n, params=p, device=card0)),
                        ("mesh", lambda: ShardedSim(n, make_mesh(devices=[card0] * MESH_SHARDS),
                                                    params=p))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sim = sims[label] = make()
        sim.bootstrap()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(sched)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[label] = dict(ms_per_tick=wall / ticks * 1e3, node_ticks_per_s=n * ticks / wall,
                          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        if label == "mesh":
            out[label]["shard_state_gib"] = [_nbytes(tuple(x for x in st if x is not None))
                                             / 2**30 for st in sim.shard_states]
        else:
            out[label]["state_gib"] = _nbytes(tuple(x for x in sim.state if x is not None)) / 2**30
    _sim_fields_same(sims["mesh"].state, sims["twin"].state, "n=%d mesh vs twin" % n)
    out["state_equal_twin"] = True
    print("sharded sim big %s" % json.dumps(out), flush=True)
    return out


def sharded_sim_paths() -> dict:
    return dict(headline=[sharded_sim_headline(m) for m in ("fast", "farmhash")],
                classic=sharded_sim_classic_tile(), big=sharded_sim_big())


def sharded_sim_planes_headline(mode: str, n: int = N_HEAD, churn_ticks: int = 16,
                                timed_ticks: int = 16, profile_ticks: int = SIM_PROFILE_TICKS,
                                device="cuda") -> dict:
    """``ShardedSim(1024, make_mesh(4))`` (all four shards on ``cuda:0``)
    with ``obs_headline``'s planes (``flight_recorder=True``,
    ``histograms=True``, ``event_capacity`` 2^22), stepped tick by tick
    beside the planes-on ``SimCluster`` twin, the planes-off mesh and a
    planes-off twin: bootstrap, converge (``run_until_converged(96,
    quiet_after=1)``'s loop), a ``churn_ticks`` churn window (16, cut from
    ``CHURN_TICKS`` for the script's time limit).  Gates: the
    four sims' metrics equal on every tick; after each window every field
    of the mesh's joined state (the planes' included) bitwise the twin's,
    its decoded events equal to the twin's ``drain_events`` and none
    dropped (then its head and drop counter reset, as the drain resets the
    twin's); the histogram summaries equal.  Then a timed ``timed_ticks``
    and a profiled ``profile_ticks`` churn window on each: ms/tick,
    launches, device ms and host reads a tick (the mesh's reads with the
    planes on equal to off), each sim's state GiB and the peak its timed
    window allocates above what was resident, and what the planes add on
    the mesh beside what they add on the twin."""
    import numpy as np

    from ringpop_tpu_torch.models.sim import engine, flight
    from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster, _tick_at
    from ringpop_tpu_torch.obs import events as oe
    from ringpop_tpu_torch.obs import histograms as oh
    from ringpop_tpu_torch.parallel import ShardedSim, make_mesh

    cap = _pow2_at_least(flight.max_events_per_tick(n))
    base = engine.SimParams(n=n, checksum_mode=mode)
    on = base._replace(flight_recorder=True, histograms=True, event_capacity=cap)
    card0 = torch.device(device, 0) if device == "cuda" else torch.device(device)
    cuda = card0.type == "cuda"
    shards = [card0] * MESH_SHARDS
    sims = {"mesh on": ShardedSim(n, make_mesh(devices=shards), params=on),
            "mesh off": ShardedSim(n, make_mesh(devices=shards), params=base),
            "twin on": SimCluster(n=n, params=on, device=card0),
            "twin off": SimCluster(n=n, params=base, device=card0)}
    mesh, twin = sims["mesh on"], sims["twin on"]
    t_phase = time.perf_counter()

    def all_step(call, label):
        ms = {k: call(sim) for k, sim in sims.items()}
        for k in ("mesh off", "twin on", "twin off"):
            _tick_metrics_same(ms[k], ms["mesh on"], "sharded planes %s %s: %s" % (mode, label, k))
        return ms["mesh on"]

    def drained(label):
        st = mesh.state
        _sim_fields_same(st, twin.state, "sharded planes %s %s: mesh vs twin" % (mode, label))
        head, drops = int(st.ev_head), int(st.ev_drops)
        events = oe.decode_events(st.ev_buf[:head].cpu().numpy(), head, drops)
        twin_drops = twin.event_drops()
        if drops or twin_drops:
            raise AssertionError("sharded planes %s %s: %d / %d events dropped at capacity %d"
                                 % (mode, label, drops, twin_drops, cap))
        if events != twin.drain_events():
            raise AssertionError("sharded planes %s %s: decoded events differ" % (mode, label))
        zero = torch.zeros((), dtype=torch.int32, device=card0)
        mesh.state = st._replace(ev_head=zero, ev_drops=zero)
        return len(events)

    all_step(lambda c: c.bootstrap(), "bootstrap")
    counts = dict(bootstrap=drained("bootstrap"))
    converged_in = -1
    for t in range(96):
        m = all_step(lambda c: c.step(), "converge tick %d" % t)
        if t >= 1 and bool(m.converged):
            converged_in = t + 1
            break
    if converged_in < 0:
        raise AssertionError("sharded planes %s: did not converge within 96 ticks" % mode)
    counts["converge"] = drained("converge")
    sched = EventSchedule.churn_window(churn_ticks, n)
    ins = {k: sched.as_inputs(sim.device) for k, sim in sims.items()}
    for t in range(churn_ticks):
        ms = {k: sim.step(_tick_at(ins[k], t)) for k, sim in sims.items()}
        for k in ("mesh off", "twin on", "twin off"):
            _tick_metrics_same(ms[k], ms["mesh on"], "sharded planes %s churn %d: %s" % (mode, t, k))
    counts["churn"] = drained("churn")
    summary = oh.summarize(mesh.state.hist, engine.HIST_TRACKS)
    if summary != twin.drain_histograms():
        raise AssertionError("sharded planes %s: histogram summaries differ" % mode)
    for track, v in summary.items():
        if not v["count"] or None in (v["p50"], v["p95"], v["p99"]):
            raise AssertionError("sharded planes %s: track %s is empty" % (mode, track))
    mesh.state = mesh.state._replace(hist=torch.zeros_like(mesh.state.hist))
    lockstep_s = time.perf_counter() - t_phase
    # the planes' cost: the same churn window, timed, then profiled, on each
    cost = {}
    timed = EventSchedule.churn_window(timed_ticks, n)
    window = EventSchedule.churn_window(profile_ticks, n)
    for k, sim in sims.items():
        _sync(card0)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sim.run(timed)
        _sync(card0)
        states = sim.shard_states if hasattr(sim, "shard_states") else [sim.state]
        cost[k] = dict(
            ms_per_tick=(time.perf_counter() - t0) / timed_ticks * 1e3,
            state_gib=sum(_nbytes(tuple(x for x in st if x is not None)) for st in states) / 2**30,
            window_peak_above_resident_gib=((torch.cuda.max_memory_allocated() - resident) / 2**30
                                            if cuda else None),
            **_profile_window(lambda: sim.run(window), profile_ticks, card0))
    if cost["mesh on"]["host_reads_per_tick"] != cost["mesh off"]["host_reads_per_tick"]:
        raise AssertionError("sharded planes %s: host reads a tick %r on, %r off" % (
            mode, cost["mesh on"]["host_reads_per_tick"], cost["mesh off"]["host_reads_per_tick"]))
    counts["timed"] = drained("timed and profiled windows")
    hist_np = np.asarray(oh.host_counts(mesh.state.hist))
    out = dict(
        mode=mode, n=n, shards=MESH_SHARDS, event_capacity=cap, converged_in=converged_in,
        churn_ticks=churn_ticks, events=counts, drops=0, state_equal_twin=True,
        events_equal_twin=True, hist_summaries_equal=True,
        hist={k: {q: v[q] for q in ("count", "p50", "p95", "p99")} for k, v in summary.items()},
        hist_observations_after=int(hist_np.astype(np.int64).sum()), cost=cost,
        added_per_tick={
            where: {f: (None if cost[where + " on"][f] is None
                        else cost[where + " on"][f] - cost[where + " off"][f])
                    for f in ("launches_per_tick", "device_ms_per_tick", "ms_per_tick")}
            for where in ("mesh", "twin")},
        collectives_per_tick={k: v / (1 + converged_in + churn_ticks + timed_ticks + profile_ticks)
                              for k, v in sorted(mesh.comm.calls.items())},
        lockstep_s=lockstep_s,
    )
    print("sharded sim planes %s" % json.dumps(out), flush=True)
    return out


def sharded_sim_planes_paths() -> list:
    return [sharded_sim_planes_headline(m) for m in ("fast", "farmhash")]


def membership_checksums_path(n: int = N_HEAD, max_digits: int = 14, device="cuda") -> dict:
    """``fused_checksum.membership_checksums`` on ``n`` full views of the
    headline universe on the card (``fused_stream``), held against its
    plain version on the same inputs and against ``hash32_rows`` of each
    of the four ``membership_rows`` encoders' rows (``block_loop``); each
    timed."""
    import numpy as np

    from ringpop_tpu_torch.models.sim.cluster import default_addresses
    from ringpop_tpu_torch.ops import checksum_encode as ce
    from ringpop_tpu_torch.ops import farmhash as fh
    from ringpop_tpu_torch.ops import fused_checksum as fc

    dev = torch.device(device)
    uni = ce.Universe.from_addresses(default_addresses(n))
    rng = np.random.default_rng(12)
    present = rng.random((n, n)) < 0.9
    status = rng.integers(0, 4, (n, n)).astype(np.int32)
    inc = 1414142122274 + rng.integers(0, 10**9, (n, n)).astype(np.int64)
    args = (uni, torch.as_tensor(present, device=dev), torch.as_tensor(status, device=dev),
            torch.as_tensor(inc, device=dev))

    def timed(fn):
        out = fn()
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    got, ms = timed(lambda: fc.membership_checksums(*args, max_digits))
    plain, plain_ms = timed(lambda: fc.membership_checksums(*args, max_digits, impl="plain"))
    if not torch.equal(got, plain):
        raise AssertionError("membership_checksums: the kernel differs from its plain version")
    encoders = {}
    for impl in ("scatter_unique", "scatter", "gather", "gather2"):
        rows, enc_ms = timed(lambda: ce.membership_rows(*args, max_digits=max_digits, impl=impl))
        hashed, hash_ms = timed(lambda: fh.hash32_rows(*rows))
        if not torch.equal(hashed, got):
            raise AssertionError("membership_checksums != hash32_rows(membership_rows(impl=%r))"
                                 % impl)
        encoders[impl] = dict(encode_ms=enc_ms, hash_ms=hash_ms)
    out = dict(n=n, rows=n, max_digits=max_digits, ms=ms, plain_ms=plain_ms,
               equal_plain=True, equal_every_encoder=True, encoders=encoders)
    print("membership_checksums %s" % json.dumps(out), flush=True)
    return out


def _audited(label: str, call, cpu_entry: str, cpu_reads: dict) -> dict:
    """One card path under the op recorder (counts only) and
    ``torch.cuda.set_sync_debug_mode("error")``: any synchronising call
    raises, so the path must read nothing back to the host.  Warmed once
    first, outside the audit (the kernel library build, per-device
    caches).  ``cpu_entry``: the graph prong's registered CPU entry of the
    same path, whose recorded host reads stand beside the card's."""
    from ringpop_tpu_torch.analysis import dataflow

    call()
    torch.cuda.synchronize()
    rec = dataflow.Recorder(track=False)
    prev = torch.cuda.get_sync_debug_mode()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with rec:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rec.host_reads:
        raise AssertionError("%s: %d host reads on the card" % (label, rec.host_reads))
    return dict(card_host_reads=rec.host_reads, cpu_entry=cpu_entry,
                cpu_host_reads=cpu_reads[cpu_entry], ops=rec.n_ops, wall_s=wall, syncs=0)


class _AliasAudit:
    """Stands in for the kernel library's ``call`` while a path runs: each
    launch's result pointers (``_build.READ_POINTERS``: the slots after
    the operands) are held against its operand pointers, so a kernel that
    writes into one of its inputs is seen."""

    def __enter__(self):
        from ringpop_tpu_torch.ops import _build

        self.lib = _build.library()
        self.launches = 0
        self.aliased = []
        orig = self.lib.call

        def call(name, device, ptrs, *ints):
            k = _build.READ_POINTERS[name]
            reads = {p for p in ptrs[:k] if p}
            if any(p and p in reads for p in ptrs[k:]):
                self.aliased.append(name)
            self.launches += 1
            return orig(name, device, ptrs, *ints)

        self.lib.call = call
        return self

    def __exit__(self, *exc):
        del self.lib.call  # the class's method again
        return False


def _aliasing_audited(label: str, call, cpu_entry: str, cpu_reads: dict) -> dict:
    """:func:`_audited` with every kernel launch's results held against its
    operands: no result pointer may equal an operand's."""
    with _AliasAudit() as audit:
        out = _audited(label, call, cpu_entry, cpu_reads)
    if audit.aliased:
        raise AssertionError("%s: a kernel result aliases an operand in %s"
                             % (label, sorted(set(audit.aliased))))
    out.update(alias_checked_launches=audit.launches, aliased=0)
    return out


def _peak_above_resident(run) -> int:
    """``torch.cuda.max_memory_allocated`` over ``run()`` above what was
    allocated before it."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - resident


def _scale_check(entry: str, n: int, run) -> dict:
    """The measured peak of ``run`` (one tick at ``n``) against the scale
    prong's footprint polynomial of ``entry`` at ``n``: it must not exceed it."""
    from ringpop_tpu_torch.analysis import manifests, ranges, scale_budget

    poly = manifests.load(scale_budget.MANIFEST_NAME)["entries"][entry]["poly_bytes"]
    bound = ranges.poly_bytes({int(e): c for e, c in poly.items()}, n)
    peak = _peak_above_resident(run)
    if peak > bound:
        raise AssertionError("%s at n=%d: peak %d bytes above resident exceeds the "
                             "polynomial's %d" % (entry, n, peak, bound))
    return dict(entry=entry, n=n, peak_bytes=peak, poly_bytes=bound, ratio=peak / bound)


def _require_launches(wrappers, before: dict, names, label: str, dev) -> None:
    """Each of ``names`` launched on the card since ``before``."""
    for k in names:
        if dev.type == "cuda" and wrappers[k].launches == before[k]:
            raise AssertionError("%s launched no %s" % (label, k))


def analysis_path(n: int = N_HEAD, device="cuda") -> dict:
    """The static analysis (``ringpop_tpu_torch.analysis``) on the tree
    and on the card: all nine prongs run on the CPU (any finding fails the
    run; each prong's wall is printed); then the host-read audit on CUDA
    tensors, each path under the recorder, ``set_sync_debug_mode("error")``
    and the aliasing audit (no kernel result pointer equals an operand's):
    the straight-line n=1024 farmhash tick (``apply_updates``,
    ``pb_budget``, ``fused_stream``), ``BatchedSimClusters(4, 1024)``'s
    tick, ``hash32_rows`` of 1,024 real n=1024 checksum rows
    (``block_loop``) and one ``exchange`` at [1M, 16]; the scale check
    (the peak above resident of the straight-line tick and of one warm 1M
    storm tick, each at most the ``scale`` prong's polynomial at its N, and
    the budget at most the card's memory); the retrace probes on CUDA
    operands (nothing uploaded after the first step, no build, no new
    custom op; at most one library build in the whole script); and the
    gated n=1024 fast churn tick, whose ``_local_scalar_dense`` reads on
    the card must equal the same tick's on the CPU and ``tick_profile``'s
    count.  Prints one ``analysis`` line."""
    from ringpop_tpu_torch import tick_profile
    from ringpop_tpu_torch.analysis import (
        astlint, dataflow, graph_audit, kernel_coverage, noninterference, prongs,
    )
    from ringpop_tpu_torch.analysis.__main__ import PKG_ROOT
    from ringpop_tpu_torch.models.sim import batched, engine
    from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
    from ringpop_tpu_torch.models.sim.recovery import states_to
    from ringpop_tpu_torch.ops import block_loop, exchange, farmhash, fused_apply
    from ringpop_tpu_torch.ops import fused_piggyback, stream_hash

    from ringpop_tpu_torch.analysis import (
        cost, donation, manifests, overflow, retrace, scale_budget,
    )
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
    from ringpop_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    runners = {
        "ast": lambda: astlint.lint_paths(PKG_ROOT),
        "graph": graph_audit.audit_entries,
        "kernels": kernel_coverage.check_kernel_coverage,
        "noninterference": noninterference.check_noninterference,
        "overflow": overflow.check_overflow,
        "scale": scale_budget.check_against_manifest,
        "cost": cost.check_against_manifest,
        "donation": donation.check_against_manifest,
        "retrace": retrace.check_against_manifest,
    }
    if set(runners) != set(prongs.ALL_PRONGS):
        raise AssertionError("prongs without a runner here: %s"
                             % sorted(set(prongs.ALL_PRONGS) - set(runners)))
    prong_report = {}
    found = []
    # the detailed recordings first: graph and noninterference reuse them
    order = ("ast", "overflow", "scale", "cost", "graph", "kernels", "noninterference",
             "donation", "retrace")
    for name in order:
        t0 = time.perf_counter()
        fs = runners[name]()
        prong_report[name] = dict(wall_s=time.perf_counter() - t0, findings=len(fs))
        found.extend(fs)
    print("analysis prongs %s" % json.dumps(prong_report), flush=True)
    if found:
        from ringpop_tpu_torch.analysis.findings import render_text
        raise AssertionError("static analysis findings:\n" + render_text(found))
    cpu_reads = {name: len(r.recording.host_reads)
                 for name, r in graph_audit._TRACE_CACHE.items()}
    budget = dict(hbm_budget_bytes=scale_budget.HBM_BUDGET_BYTES,
                  total_memory=torch.cuda.get_device_properties(0).total_memory)
    if budget["hbm_budget_bytes"] > budget["total_memory"]:
        raise AssertionError("the scale budget %d exceeds the card's %d bytes"
                             % (budget["hbm_budget_bytes"], budget["total_memory"]))

    wrappers = {"apply_updates": fused_apply.apply_updates, "pb_budget": fused_piggyback.pb_budget,
                "fused_stream": stream_hash.fused_stream, "block_loop": block_loop.block_loop,
                "exchange": exchange.exchange}
    k0 = {k: w.launches for k, w in wrappers.items()}
    dev = torch.device(device)
    entries = {}

    # the straight-line tick
    sim = SimCluster(n=n, params=engine.SimParams(n=n, gate_phases=False), device=device)
    sim.bootstrap()
    sim.run(EventSchedule(ticks=8, n=n))
    pre, quiet = sim.state, sim.quiet_inputs()
    kill = quiet._replace(kill=quiet.kill.clone().index_fill_(
        0, torch.tensor([5, n // 3, 2 * n // 3], device=dev), True))
    launches = {k: w.launches for k, w in wrappers.items()}
    entries["straight-line tick n=%d farmhash" % n] = _aliasing_audited(
        "straight-line tick", lambda: engine.tick(pre, kill, sim.params, sim.universe),
        "engine-tick-straight", cpu_reads)
    _require_launches(wrappers, launches, ("apply_updates", "pb_budget", "fused_stream"),
                      "the straight-line tick", dev)
    scale = {"straight-line tick n=%d farmhash" % n: _scale_check(
        "engine-tick-straight", n, lambda: engine.tick(pre, kill, sim.params, sim.universe))}
    del sim, pre

    # the batched tick, B = 4
    bat = batched.BatchedSimClusters(4, n, device=device)
    bat.bootstrap()
    bstate = bat.state
    launches = {k: w.launches for k, w in wrappers.items()}
    entries["BatchedSimClusters(4, %d) tick" % n] = _aliasing_audited(
        "batched tick", lambda: bat._tick(bstate, kill), "batched-tick", cpu_reads)
    _require_launches(wrappers, launches, ("apply_updates", "pb_budget"), "the batched tick",
                      dev)
    del bat, bstate

    # hash32_rows over real checksum rows: block_loop
    mat, lens = _checksum_rows(n, 1024, 7, dev)
    launches = {k: w.launches for k, w in wrappers.items()}
    entries["hash32_rows [1024, %d]" % mat.shape[1]] = _aliasing_audited(
        "hash32_rows", lambda: farmhash.hash32_rows(mat, lens), "farmhash-kernel", cpu_reads)
    _require_launches(wrappers, launches, ("block_loop",), "hash32_rows", dev)
    del mat, lens

    # one exchange at the 1M storm's shape
    args = _exchange_inputs(N_STORM, 16, 11, dev)
    launches = {k: w.launches for k, w in wrappers.items()}
    entries["exchange [%d, 16]" % N_STORM] = _aliasing_audited(
        "exchange", lambda: exchange.exchange(*args, want_counts=False), "exchange-kernel",
        cpu_reads)
    _require_launches(wrappers, launches, ("exchange",), "the exchange call", dev)
    del args

    # one warm 1M storm tick against the scalable entry's polynomial
    storm = ScalableCluster(n=N_STORM, params=es.ScalableParams(n=N_STORM, u=512),
                            device=device)
    storm.run(StormSchedule.churn_storm(4, N_STORM, fraction=0.1, fail_tick=1))
    quiet = es.ChurnInputs.quiet(N_STORM, dev)
    scale["warm 1M storm tick"] = _scale_check(
        "engine-scalable-tick", N_STORM, lambda: es.tick(storm.state, quiet, storm.params))
    del storm, quiet

    # the retrace probes on the card: after the first step nothing uploads
    # (straight probes under set_sync_debug_mode("error")) and the custom
    # ops stay as they were
    t0 = time.perf_counter()
    probes = retrace.run_probes(device=device, sync_error=True)
    for name, steps in probes.items():
        if any("error" in st for st in steps):
            raise AssertionError("retrace probe %s on the card: %s" % (name, steps))
        if any(st["uploads"] for st in steps[1:]):
            raise AssertionError("retrace probe %s uploaded after its first step: %s"
                                 % (name, steps))
        if len({st["custom_ops"] for st in steps}) != 1 or any(
                st["library_builds"] for st in steps):
            raise AssertionError("retrace probe %s registered or built: %s" % (name, steps))
    retrace_report = dict(
        probes={k: [st["uploads"] for st in v] for k, v in probes.items()},
        custom_ops=probes["exchange"][0]["custom_ops"],
        straight=[p.name for p in retrace.DEFAULT_PROBES if p.straight],
        wall_s=time.perf_counter() - t0)

    # the gated fast churn tick: card, CPU and the profiler's count
    params = engine.SimParams(n=n, checksum_mode="fast")
    sim = SimCluster(n=n, params=params, device=device)
    sim.bootstrap()
    if sim.run_until_converged(max_ticks=96, quiet_after=1) < 0:
        raise AssertionError("the gated n=%d cluster did not converge" % n)
    _kill_tick(sim, (5, n // 3, 2 * n // 3))
    sched = EventSchedule(ticks=1, n=n)
    sched.kill[0, n - 100 if n > 200 else n - 1] = True
    pre = sim.state
    rec = dataflow.Recorder(track=False)
    with rec:
        sim.run(sched)
    torch.cuda.synchronize()
    card_state = sim.state
    sim.state = pre
    prof = tick_profile._profiled(sim, sched)
    sim.state = pre
    cpu = SimCluster(n=n, params=params, device="cpu")
    cpu.state = states_to(pre, "cpu")
    cpu_rec = dataflow.Recorder(track=False)
    with cpu_rec:
        cpu.run(sched)
    if not torch.equal(cpu.state.checksum, card_state.checksum.cpu()):
        raise AssertionError("the gated tick's checksums differ, card against CPU")
    gated = dict(card_scalar_reads=rec.scalar_reads, cpu_scalar_reads=cpu_rec.scalar_reads,
                 tick_profile_scalar_reads=prof["host_reads"], card_host_reads=rec.host_reads,
                 cpu_host_reads=cpu_rec.host_reads, card_ops=rec.n_ops, cpu_ops=cpu_rec.n_ops)
    if not rec.scalar_reads == cpu_rec.scalar_reads == prof["host_reads"]:
        raise AssertionError("gated tick host reads: card %d, CPU %d, tick_profile %d"
                             % (rec.scalar_reads, cpu_rec.scalar_reads, prof["host_reads"]))
    entries["gated churn tick n=%d fast" % n] = gated
    del sim, cpu, pre, card_state

    if _build.BUILDS > 1:
        raise AssertionError("the kernel library was built %d times" % _build.BUILDS)
    out = dict(card=_card_line(), prongs=prong_report,
               prong_wall_s=sum(p["wall_s"] for p in prong_report.values()),
               findings=len(found), entries=entries, scale=scale, budget=budget,
               retrace=retrace_report, library_builds=_build.BUILDS,
               cost_manifest_torch=manifests.load(cost.MANIFEST_NAME).get("torch_version"),
               launches={k: w.launches - k0[k] for k, w in wrappers.items()},
               phase_s=time.perf_counter() - t_phase)
    print("analysis %s" % json.dumps(out), flush=True)
    return out


def check_sharded_sim_tiles(report: dict) -> None:
    """(d) Each kernel on one shard's own ``[256, 1024]`` tile, kept from the
    mesh paths (``apply_updates`` at a shard with ``lo != 0``), after the
    paths' counts are read: bitwise equal to its plain version, timed with
    the L2 flushed before each call, with its byte bound."""
    from ringpop_tpu_torch.ops import block_loop as bl
    from ringpop_tpu_torch.ops import fused_apply as fa
    from ringpop_tpu_torch.ops import fused_piggyback as fp
    from ringpop_tpu_torch.ops import stream_hash as sh

    if sorted(SIM_TILES) != ["apply_updates", "block_loop", "fused_stream", "pb_budget"]:
        raise AssertionError("kept shard tiles of %s" % sorted(SIM_TILES))
    args, kw = SIM_TILES["apply_updates"]
    args = (fa.ApplyState(*args[0]),) + tuple(args[1:])
    rows, n = args[1].shape
    kernels = {
        "apply_updates": (lambda: fa.apply_updates(*args, **kw),
                          lambda: fa.apply_updates_plain(*args, **kw), "apply_updates_kernel",
                          40.0 * rows * n),
    }
    b_args, b_kw = SIM_TILES["pb_budget"]
    kernels["pb_budget"] = (lambda: fp.pb_budget(*b_args, **b_kw),
                            lambda: fp.pb_budget_plain(*b_args, **b_kw), "pb_budget_kernel",
                            8.0 * b_args[1].numel())
    s_args, _ = SIM_TILES["fused_stream"]
    kernels["fused_stream"] = (lambda: sh.fused_stream(*s_args),
                               lambda: sh.fused_stream_plain(*s_args), "fused_stream_kernel",
                               10.0 * s_args[3].shape[0] * s_args[3].shape[1]
                               * (s_args[3].shape[2] + 5) + 40.0 * float(s_args[5].sum()))
    l_args, _ = SIM_TILES["block_loop"]
    rounds = int(l_args[4].clamp(0, l_args[3].shape[1]).sum())
    kernels["block_loop"] = (lambda: bl.block_loop(*l_args), lambda: bl.block_loop_plain(*l_args),
                             "block_loop_kernel", 31.0 * rounds)
    for name, (kernel, plain, symbol, ops) in kernels.items():
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        _same(tuple(got), tuple(want), "%s shard tile" % name)
        if name == "block_loop":
            moved = 20 * rounds + 7 * 4 * l_args[3].shape[0]
        elif name == "apply_updates":
            moved = _nbytes(tuple(args[0]) + tuple(args[1:6]) + (args[8],)) + _nbytes(tuple(got))
        else:
            moved = _nbytes(tuple(a for a in (b_args if name == "pb_budget" else s_args)
                                  if isinstance(a, torch.Tensor))) + _nbytes(tuple(got))
        r = dict(_times(kernel, 20, symbol, evict=True), bound=_bound(moved, ops))
        r["plain_ms"] = _time_ms(plain, 1, warm=0)
        r["shape"] = (list(args[1].shape) if name == "apply_updates" else
                      list((b_args[1] if name == "pb_budget" else
                            s_args[3] if name == "fused_stream" else l_args[3]).shape))
        if name == "apply_updates":
            r["lo"] = kw["lo"]
        print("%s shard tile %s: device %.4f ms (L2 flushed), plain %.4f ms, bound %.4f ms (%s)"
              % (name, r["shape"], r["device_ms"], r["plain_ms"], r["bound"][0], r["bound"][1]),
              flush=True)
        report[name]["shard_tile"] = dict(
            {k: r[k] for k in ("shape", "device_ms", "device_ms_method", "call_ms", "plain_ms")},
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            share_of_bound=r["bound"][0] / r["device_ms"], **({"lo": r["lo"]} if "lo" in r else {}))


def main(argv) -> int:
    quick = "--quick" in argv

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from ringpop_tpu_torch.ops import _build, toolkit
        wrappers = _wrappers()
    except ImportError as e:
        print("chip_smoke: run from a checkout of the repo (%s)" % e, file=sys.stderr)
        return 2
    card = _card_line()
    print("card: %s" % card, flush=True)
    print("python %s torch %s cuda %s" % (sys.version.split()[0], torch.__version__,
                                          torch.version.cuda), flush=True)

    lib = _build.library(verbose=quick)
    print("kernel build: %.1f s (%s, %s)" % (lib.build_seconds, "built" if lib.built else "cached",
                                            lib.path.name), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    report = check_kernels(dev)
    report["exchange"] = check_exchange(dev)
    report["block_loop"] = check_block_loop(dev)
    print("check_kernels, check_exchange, check_block_loop: %.1f s"
          % (time.perf_counter() - t0), flush=True)
    t0 = time.perf_counter()
    batch_report = check_batch_rules(dev)
    print("check_batch_rules: %.1f s" % (time.perf_counter() - t0), flush=True)
    for phase in (check_e2e, check_sharded_sim_e2e, check_batched_e2e, check_fuzz_e2e,
                  check_storm_e2e, check_storm_planes_e2e, check_mesh_e2e, check_mesh_planes_e2e,
                  check_route_e2e, check_ckpt_e2e):
        t0 = time.perf_counter()
        phase()
        print("%s: %.1f s" % (phase.__name__, time.perf_counter() - t0), flush=True)

    # each main path and the kernels it must launch
    paths = (
        ("SimCluster n=1024", lambda: [headline(m) for m in ("fast", "farmhash")],
         ("apply_updates", "pb_budget", "fused_stream")),
        # the full engine on a 4-shard mesh: each shard launches the kernels
        # on its own rows (and the classic bootstrap's block_loop, n=8192)
        ("SimCluster n=1024 on the shard mesh", sharded_sim_paths,
         ("apply_updates", "pb_budget", "fused_stream", "block_loop")),
        ("1M storm", storm_headline, ("exchange",)),
        # killed mid-save and resumed: held to the 1M storm's warm run
        ("checkpointed storms", ckpt_paths, ("exchange",)),
        # the 1M storm on a 4-shard mesh: one exchange launch a shard a tick
        ("1M storm on the shard mesh", mesh_headline, ("exchange",)),
        ("SimCluster n=1024 classic", classic_headline, ("block_loop",)),
        ("routed storm", route_headline, ("exchange",)),
        # the obs planes at full width, each against its planes-off run
        ("SimCluster n=1024 obs planes", obs_paths, ("apply_updates", "pb_budget", "fused_stream")),
        ("1M storm obs planes", storm_planes_headline, ("exchange",)),
        # the obs planes on both meshes, each beside its single-device twin
        ("SimCluster n=1024 obs planes on the shard mesh", sharded_sim_planes_paths,
         ("apply_updates", "pb_budget", "fused_stream")),
        ("1M storm obs planes on the shard mesh", mesh_planes_headline, ("exchange",)),
        ("membership_checksums n=1024", membership_checksums_path,
         ("fused_stream", "block_loop")),
        ("routed 1M storm histograms", route_planes_headline, ("exchange",)),
        ("tick-cluster", tick_cluster_headline,
         ("apply_updates", "pb_budget", "fused_stream", "exchange")),
        # the host obs layer (timers, trace tap, profiler harness, SLO plane)
        # around the n=1024 planes-on cluster and the n=4096 routed storm
        ("obs host layer", obs_host_path,
         ("apply_updates", "pb_budget", "fused_stream", "exchange")),
        # the batch axis: B clusters a tick, and the fuzz campaigns
        ("BatchedSimClusters n=1024", batched_paths, ("apply_updates", "pb_budget", "fused_stream")),
        ("fuzz sweeps", fuzz_throughput, ("apply_updates", "pb_budget")),
        # the port's engine in lockstep with the port's host oracle
        # (parity/oracle.py), fused and classic, and five live node processes
        ("parity n=%d against the port's oracle" % PARITY_N, parity_fused_path,
         ("apply_updates", "pb_budget", "fused_stream")),
        ("parity n=%d classic against the port's oracle" % PARITY_CLASSIC_N, parity_classic_path,
         ("block_loop",)),
        ("live nodes", live_path, ()),
        # the static analysis on the tree, and the host-read audit of the
        # kernel paths on the card under set_sync_debug_mode("error")
        ("analysis", analysis_path,
         ("apply_updates", "pb_budget", "fused_stream", "block_loop", "exchange")),
    )
    launches = {k: 0 for k in wrappers}
    if not quick:
        for name, drive, needed in paths:
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            drive()
            print("launches on the %s path (%.1f s): %s" % (
                name, time.perf_counter() - t0,
                json.dumps({k: w.launches for k, w in wrappers.items()})), flush=True)
            for k, w in wrappers.items():
                launches[k] += w.launches
            for k in needed:
                if wrappers[k].launches == 0:
                    raise AssertionError("kernel %s was never launched on the %s path" % (k, name))
        check_exchange_storm_operands(report["exchange"])
        check_mesh_tile_operands(report["exchange"])
        check_sharded_sim_tiles(report)
    kernels = []
    for twin in toolkit.TWIN_REGISTRY:
        r = report[twin.kernel_entry]
        extra = {k: r[k] for k in ("chain_bound_ms", "new_bits_per_word", "share_of_bound", "plan",
                                   "shard_tile") if k in r}
        # exchange's other timed operand sets: no new bit, the storm's own,
        # the small and ragged shapes
        for k in ("no_new_bits", "storm_operands", "ragged"):
            if k in r:
                cases = r[k] if k != "no_new_bits" else {k: r[k]}
                extra.setdefault("cases", {}).update({c: _brief(v) for c, v in cases.items()})
        if twin.also_replaces:
            extra["also_replaces"] = list(twin.also_replaces)
        # the batching rule: one launch for B clusters, at B in BATCHES
        extra["batched"] = {k: dict({f: v[f] for f in ("device_ms", "call_ms", "bound_ms",
                                                       "launches_per_call", "max_abs_err")},
                                    **_events_method(v))
                            for k, v in batch_report[twin.kernel_entry].items()}
        kernels.append(dict(
            name=twin.kernel_entry,
            route="cuda",
            source=twin.source,
            replaces=twin.replaces,
            launches=launches[twin.kernel_entry],
            max_abs_err=r["max_abs_err"],
            ms=r["ms"],
            call_ms=r["call_ms"],
            device_ms=r["device_ms"],
            device_ms_method=r["device_ms_method"],
            device_launches_seen=r["device_launches_seen"],
            plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0],
            bound_by=r["bound"][1],
            library_ms=None,
            checked=True,
            **extra,
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
