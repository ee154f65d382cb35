"""Device-side log2-bucketed latency histograms.

Counterpart of ``ringpop_tpu/ops/histogram.py``: a fixed-shape
``[tracks, NBUCKETS]`` counter array carried through the tick as an
ordinary state field and bumped under the same masks that drive the
trajectory (write-only: nothing in the protocol reads the counts, so the
plane is trajectory-neutral).  The counters are uint32 in the JAX package;
here they are int32 tensors of the same bit patterns (ops/u32.py), and a
bump wraps mod 2^32 exactly as the uint32 scatter-add does.

Bucketing: bucket 0 holds exactly 0; bucket ``b >= 1`` holds
``[2^(b-1), 2^b - 1]``, so every non-negative int32 lands in one of the 32
buckets.  Negative values are invalid observations (``record`` drops
them).

What differs from the JAX op is the arithmetic, not the result:

- the bucket is the bit length of the value, read off the exponent of
  ``torch.frexp`` on the value as float64 (exact for every int32), where
  the JAX op counts 31 thresholds (one fused pass under XLA, ~62 launches
  eagerly);
- the per-bucket counts are a compare against the 33 bucket ids summed
  over the lanes (lanes past the bucket axis are the dropped ones), not a
  scatter-add: no atomics contend on 33 addresses and nothing reads the
  host (``torch.bincount`` reads the maximum back on the card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from portbench.reference.frozen.ops import u32

NBUCKETS = 32

# lanes per compare-and-sum pass (the [lanes, NBUCKETS + 1] bool temporary
# of one pass is 33 bytes a lane)
_CHUNK = 1 << 22


def init(tracks: int, device="cpu") -> torch.Tensor:
    """Zeroed ``[tracks, NBUCKETS]`` counters (uint32 bit patterns)."""
    return torch.zeros((tracks, NBUCKETS), dtype=torch.int32, device=device)


def bucket_index(values: torch.Tensor) -> torch.Tensor:
    """[...] int -> [...] int32 bucket index: the bit length of the value
    (``0`` for 0, ``floor(log2(v)) + 1`` above), clamped to 31; negative
    values give bucket 0, as the JAX op's threshold count does."""
    v = values.to(torch.float64).clamp(min=0)
    return torch.frexp(v).exponent.to(torch.int32).clamp(max=NBUCKETS - 1)


def bucket_counts(idx: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[NBUCKETS] int64: per bucket, the lanes of ``idx`` (ids in
    ``[0, NBUCKETS]``; ``NBUCKETS`` = dropped) that fall in it, or the sum
    of their ``weights`` (int, same shape as ``idx``)."""
    idx = idx.reshape(-1)
    w = None if weights is None else weights.reshape(-1).to(torch.int64)
    ids = torch.arange(NBUCKETS, dtype=idx.dtype, device=idx.device)
    out = None
    for lo in range(0, max(idx.numel(), 1), _CHUNK):
        hit = idx[lo:lo + _CHUNK, None] == ids[None, :]
        if w is None:
            part = hit.sum(dim=0, dtype=torch.int64)
        else:
            part = (hit * w[lo:lo + _CHUNK, None]).sum(dim=0, dtype=torch.int64)
        out = part if out is None else out + part
    return out


def _bump(hist: torch.Tensor, track: int, counts: torch.Tensor) -> torch.Tensor:
    """``hist[track] += counts`` mod 2^32, as a new tensor."""
    row = u32.from_u64(counts)[None, :]
    h = hist.shape[0]
    return hist + torch.nn.functional.pad(row, (0, 0, track, h - 1 - track))


def record(
    hist: torch.Tensor,  # [H, NBUCKETS] int32 (uint32 bits)
    track: int,  # static track index
    values: torch.Tensor,  # [...] int observations
    mask: torch.Tensor,  # [...] bool — which lanes are real observations
) -> torch.Tensor:
    """Masked bump of up to M observations into one track; masked-out and
    negative lanes are dropped.  Returns the new counters."""
    values = values.reshape(-1)
    ok = mask.reshape(-1) & (values >= 0)
    idx = torch.where(ok, bucket_index(values), NBUCKETS)
    return _bump(hist, track, bucket_counts(idx))


def record_weighted(
    hist: torch.Tensor,
    track: int,
    values: torch.Tensor,  # [M] int observations
    weights: torch.Tensor,  # [M] int — how many times each value was seen
) -> torch.Tensor:
    """``weights[i]`` observations of ``values[i]`` for every lane (negative
    values dropped): the same counters as :func:`record` over the lanes
    repeated, mod 2^32, without materializing them."""
    values = values.reshape(-1)
    idx = torch.where(values >= 0, bucket_index(values), NBUCKETS)
    return _bump(hist, track, bucket_counts(idx, weights))


def record_count(hist: torch.Tensor, track: int, value: torch.Tensor) -> torch.Tensor:
    """One scalar observation (per-tick size metrics), recorded once."""
    v = value.to(torch.int32).reshape(1)
    return record(hist, track, v, torch.ones(1, dtype=torch.bool, device=v.device))


# -- host-side bucket arithmetic (shared with obs.histograms) -------------


def bucket_lo(b: int) -> int:
    """Smallest value bucket ``b`` holds."""
    return 0 if b == 0 else 1 << (b - 1)


def bucket_hi(b: int) -> int:
    """Largest value bucket ``b`` holds."""
    return 0 if b == 0 else (1 << b) - 1


def bucket_index_np(values) -> np.ndarray:
    """Host/numpy reference of :func:`bucket_index`."""
    v = np.asarray(values, np.int64)
    out = np.zeros(v.shape, np.int64)
    nz = v > 0
    out[nz] = np.floor(np.log2(v[nz])).astype(np.int64) + 1
    return np.clip(out, 0, NBUCKETS - 1).astype(np.int32)
