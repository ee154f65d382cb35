"""Field-by-field comparison of two engine states or metric series."""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


def count_differing(a, b, fields: Iterable[str]) -> Dict[str, int]:
    """Per field, how many elements of ``a`` and ``b`` differ (a shape
    mismatch counts every element of the larger)."""
    out = {}
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None and y is None:
            continue
        if x is None or y is None:
            out[f] = int((y if x is None else x).numel())
            continue
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            out[f] = (int(max(x.size, y.size)) if x.shape != y.shape
                      else int(np.count_nonzero(x != y)))
            continue
        if tuple(x.shape) != tuple(y.shape):
            out[f] = int(max(x.numel(), y.numel()))
            continue
        out[f] = int((x.to(y.device) != y).sum())
    return out


def total(counts: Dict[str, int]) -> int:
    return int(sum(counts.values()))


def worst(counts: Dict[str, int]) -> str:
    """The fields that differ, most first (for the report)."""
    bad = sorted(((v, k) for k, v in counts.items() if v), reverse=True)
    return ",".join("%s:%d" % (k, v) for v, k in bad[:6]) or "none"
