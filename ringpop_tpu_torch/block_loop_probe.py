"""Where a FarmHash32 block-loop round's time goes on the card.

    python3 -m ringpop_tpu_torch.block_loop_probe [--out FILE]

Builds ``csrc/probe/block_loop_rounds.cu`` (loop shapes of the first,
thread-per-row ``block_loop`` kernel side by side; see its header for the
modes) with
nvcc, runs each mode on the rows ``chip_smoke.py`` times — B = 1024 and
256 rows of the real n=1024 checksum strings (I = 1843) — and on B = 32
(one warp), checks every mode that reads the blocks against
``block_loop_plain`` bit for bit, and reports per mode the kernel time
(CUDA events over 50 launches), the median SM cycles a row spends per
round (each thread's ``clock64()`` around its loop) and the shipped
wrapper's time.  Mode 2, the mixing chain with no loads, measures the
dependency-chain bound directly.  Prints one JSON object as its last line;
needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

MODES = {
    0: "register prefetch 1 stage ahead, branch per round",
    1: "register prefetch 1 stage ahead, predicated",
    2: "mixing chain only (no loads)",
    3: "register prefetch 2 stages ahead, predicated",
    4: "register prefetch 3 stages ahead, predicated",
    5: "cp.async shared-memory ring, 3 stages ahead, predicated",
    6: "cp.async shared-memory ring, 5 stages ahead, predicated",
}


def _library():
    from ringpop_tpu_torch.ops import _build

    src = _build.CSRC / "probe" / "block_loop_rounds.cu"
    out = _build.BUILD / "probe" / "libblock_loop_rounds.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas=-v", "-shared", "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n%s" % res.stdout)
    lib = ctypes.CDLL(str(out))
    fn = lib.ringpop_block_loop_rounds
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, ci, ci, ci, vp]
    fn.restype = ci
    return fn, res.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("block_loop_probe: needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from ringpop_tpu_torch.ops import block_loop as bl

    fn, ptxas = _library()
    print(ptxas, flush=True)
    dev = torch.device("cuda")

    def run(mode, h0, g0, f0, blocks, iters):
        B, n_iter, _ = blocks.shape
        out = [torch.empty_like(h0) for _ in range(3)]
        cycles = torch.empty(B, dtype=torch.int64, device=dev)
        ptrs = [t.data_ptr() for t in (h0, g0, f0, blocks, iters, *out, cycles)]
        err = fn(mode, (ctypes.c_void_p * 9)(*ptrs), B, n_iter, blocks.stride(0),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError("mode %d: cudaError %d" % (mode, err))
        return out, cycles

    result = dict(card=cs._card_line(), sm_clock_max_hz=cs._sm_clock_hz(), modes=MODES, rows={})
    for rows in (1024, 256, 32):
        a = cs._block_inputs(rows, 11 + rows, dev)
        want = bl.block_loop_plain(*a)
        n = a[4].clamp(min=1).to(torch.float64)
        per = dict(shipped_ms=cs._time_ms(lambda: bl.block_loop(*a), 50),
                   rounds_max=int(a[4].max()))
        for mode in MODES:
            out, cycles = run(mode, *a)
            torch.cuda.synchronize()
            if mode != 2 and not all(torch.equal(x, y) for x, y in zip(out, want)):
                raise AssertionError("mode %d differs from block_loop_plain at B=%d" % (mode, rows))
            per[mode] = dict(
                ms=cs._time_ms(lambda: run(mode, *a), 50),
                cycles_per_round=float((cycles.to(torch.float64) / n).median()),
            )
        result["rows"][rows] = per
        print("B=%d: %s" % (rows, json.dumps(per)), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
