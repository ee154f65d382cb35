"""Zipf request traffic for the routing plane.

Counterpart of ``ringpop_tpu/models/route/traffic.py``: a Zipf(s) draw over
a static universe of ``K`` keys.  The CDF over the K ranks is built once
(:func:`zipf_cdf`); sampling is one uniform draw and one ``searchsorted``
per query, and :func:`key_hashes` maps a key id to its ring position with
the record hash (the scale analog of FarmHash32 of the key string,
lib/ring/index.js:145-147).

The CDF must equal the JAX one bit for bit, since every sampled key id
depends on it.  JAX computes ``ranks ** float32(-s)`` and a float32
``cumsum`` on the XLA CPU backend; this module reproduces both on the host
in numpy: the power in float64 with the exponent ``float64(float32(-s))``,
rounded to float32, and the cumsum as XLA's reduce-window lowering orders
it (:func:`_xla_cumsum_f32`).
"""

from __future__ import annotations

import numpy as np
import torch

from ringpop_tpu_torch.ops import threefry
from ringpop_tpu_torch.ops.record_mix import record_mix

_SCAN_BLOCK = 16


def _xla_cumsum_f32(x: np.ndarray) -> np.ndarray:
    """float32 inclusive prefix sums in XLA CPU's order: sequential sums
    inside blocks of 16, the block totals scanned the same way
    (recursively), each block's offset then added to its local sums."""
    x = np.asarray(x, dtype=np.float32)
    k = x.shape[0]
    if k <= _SCAN_BLOCK:
        return np.add.accumulate(x, dtype=np.float32)
    nb = -(-k // _SCAN_BLOCK)
    padded = np.zeros(nb * _SCAN_BLOCK, np.float32)
    padded[:k] = x
    local = np.add.accumulate(padded.reshape(nb, _SCAN_BLOCK), axis=1, dtype=np.float32)
    totals = _xla_cumsum_f32(local[:, -1])
    out = local.copy()
    out[1:] = local[1:] + totals[:-1, None]
    return out.reshape(-1)[:k]


def zipf_cdf(n_keys: int, s: float, device="cpu") -> torch.Tensor:
    """[K] float32 CDF of Zipf(s) over key ranks 1..K (built once, on the
    host, then moved to ``device``)."""
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    w = np.power(ranks, np.float64(np.float32(-s))).astype(np.float32)
    c = _xla_cumsum_f32(w)
    return torch.from_numpy(c / c[-1]).to(device)


def sample_keys(key: torch.Tensor, cdf: torch.Tensor, q: int) -> torch.Tensor:
    """[Q] int32 key ids drawn Zipf-distributed by inverse CDF."""
    u = threefry.uniform_f32(key, (q,))
    ids = torch.searchsorted(cdf, u, side="left").to(torch.int32)
    return ids.clamp(0, cdf.shape[0] - 1)


def key_hashes(key_ids: torch.Tensor, salt: int = 0x51C7E7) -> torch.Tensor:
    """[Q] int32 (uint32) ring-position hashes of integer key ids."""
    z = torch.zeros_like(key_ids)
    return record_mix(key_ids, z + salt, z)
