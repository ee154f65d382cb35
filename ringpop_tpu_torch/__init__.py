"""ringpop_tpu_torch — the PyTorch/CUDA port of ringpop_tpu.

The JAX package ``ringpop_tpu`` is the reference; this package mirrors its
layout module by module (``ops/``, ``models/sim/``) and is held against it
bit for bit.  It imports ``torch`` and numpy only.

Entry points take an explicit ``device``.  ``None`` means the card
(``"cuda"``); the CPU runs only when the caller asks for ``"cpu"``, and a
request for the card on a machine without one raises instead of quietly
running on the CPU.  On the CPU every kernel wrapper runs its plain PyTorch
version; on the card it launches the hand-written CUDA kernel
(``csrc/``, built on first use by :mod:`ringpop_tpu_torch.ops._build`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller passed
    ``"cpu"``.  Raises when the card is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ringpop_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (dev,))
    return dev
