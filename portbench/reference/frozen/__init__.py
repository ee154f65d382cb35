"""A frozen copy of the port's plain engine: the benchmark's regression twin.

These modules are the port's engine and scalable engine and the plain
PyTorch versions of their kernels as they stood when the benchmark was
written, with the package name rewritten so that nothing here imports the
program, cut to what the twin runs: the full engine with the fast
checksum and no obs plane (its FarmHash32 paths, flight recorder and
histograms are gone).  The program may change after this; the twin does
not.  It follows the program's trajectory; the guarantees themselves are
judged by the benchmark's own code beside this folder.

The twin runs with every kernel knob on its plain version
(``fused_tick="plain"``, ``fused_exchange="plain"``):
``ops/_build.py`` here is a stub that raises, so no CUDA kernel of the
program can be reached.  The custom ops register under the namespace
``portbench_ref``, apart from the program's.
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
            "portbench.reference.frozen: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (dev,))
    return dev
