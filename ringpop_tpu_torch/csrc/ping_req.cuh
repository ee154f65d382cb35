// Shared by the four ping-req sources (ping_req_select.cu,
// ping_req_combine.cu, ping_req_hits.cu, ping_req_respond.cu): the full
// engine's ping-req phase (phase 7 of models/sim/engine.py) for one shard
// holding every row, B clusters' [N, N] planes a launch.  The
// intermediaries are picked by a row scan, and only the slots whose
// intermediary answered do any work: the same values as the plain
// versions in ops/ping_req.py, which are the engine's plain phase.
//
// Replaces no Pallas kernel.  It stands in for the ping-req leg of the JAX
// engine's tick (ringpop_tpu/models/sim/engine.py `_ping_req_phase`),
// which the port ran as plain PyTorch ops over the whole [B, N, N] planes
// every tick: a hashed float score plane fully argsorted per row to keep
// K = 3 columns, [B, N * K, N] slot planes folded onto the intermediaries
// by four scatter_reduce calls (every slot that did not answer going to
// a drop row), a dense [N, N] arrival-count plane, and K x 8 whole-plane
// row gathers to combine the responses.  In the churn ensemble about 1-2%
// of the rows need a ping-req at all.
//
// Bound on an H100: bytes.  The dense passes write the apply sites'
// update planes (17 bytes a cell for each leg, 4 for the hits; the hits
// read the active plane) and read nothing else of a row no answering slot
// touches; the sparse work reads an answering slot's rows (a few KB
// each).  About 1.3 GB at [32, 1024, 1024] of writes, 0.4 ms at 3.35 TB/s,
// whatever the share of rows that need a ping-req.
#pragma once

#include "common.cuh"

namespace ping_req {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// The shapes every entry point takes: b clusters of n rows (one shard
// holding every row), k slots a row, 1 <= k <= n, b * n rows and n * k
// slot ids within int32.
inline bool shapes_ok(int b, int n, int k) {
  return b > 0 && n > 0 && k >= 1 && k <= n &&
         static_cast<long long>(b) * n <= INT32_MAX &&
         static_cast<long long>(n) * k < INT32_MAX;
}

}  // namespace ping_req
