"""Read many tensors to the host in one transfer.

``to_host(tensors)`` packs every tensor's bytes into one device buffer
(each piece 8-byte aligned), copies that buffer to the host once, and
returns numpy arrays viewing the host copy in each tensor's own dtype and
shape.  On the card this is one synchronising device-to-host copy instead
of one per tensor; on the CPU the packing itself is the copy, so the
arrays never alias memory a later in-place write may change.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

_NUMPY = {
    torch.bool: np.bool_,
    torch.uint8: np.uint8,
    torch.int8: np.int8,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.float32: np.float32,
    torch.float64: np.float64,
}
_ALIGN = 8


def to_host(tensors: Sequence[Optional[torch.Tensor]]) -> List[Optional[np.ndarray]]:
    """Host copies of ``tensors`` (None entries stay None), all read in
    one device-to-host transfer.  The tensors must share one device."""
    present = [t for t in tensors if t is not None]
    if not present:
        return [None] * len(tensors)
    dev = present[0].device
    pieces, spans, off = [], [], 0
    for t in present:
        if t.device != dev:
            raise ValueError("to_host: tensors on %s and %s" % (dev, t.device))
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        pieces.append(b)
        spans.append((off, b.numel(), _NUMPY[t.dtype], tuple(t.shape)))
        off += b.numel()
        pad = -off % _ALIGN
        if pad:
            pieces.append(torch.zeros(pad, dtype=torch.uint8, device=dev))
            off += pad
    buf = torch.cat(pieces).to("cpu").numpy()
    arrays = iter([buf[o:o + nb].view(dt).reshape(shape) for o, nb, dt, shape in spans])
    return [None if t is None else next(arrays) for t in tensors]
