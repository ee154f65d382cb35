"""Host helpers of a live node (ringpop-node lib/util.js and lib/nulls.js).

A copy of the host helpers of ``ringpop_tpu/utils/util.py``:
``HOST_PORT_PATTERN``, :func:`capture_host`, :func:`num_or_default`,
:func:`safe_parse`, :func:`map_uniq` and :func:`null_logger`.  The JAX
module's backend plumbing (``clear_jax_backends``, ``wait_for_tpu``,
``reexec_retry``, ``retry_compile_helper``, ``force_host_device_count``,
``pin_cpu_platform``) pins and retries JAX's TPU backend and has no
counterpart here: the port picks its device with
:func:`ringpop_tpu_torch.resolve_device`.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Any, Iterable, List, Optional

HOST_CAPTURE = re.compile(r"(\d+\.\d+\.\d+\.\d+):\d+")
HOST_PORT_PATTERN = re.compile(r"^(\d+\.\d+\.\d+\.\d+):\d+$")


def capture_host(host_port: str) -> Optional[str]:
    """Extract the IP from ``ip:port`` — lib/util.js:27-30."""
    m = HOST_CAPTURE.search(host_port or "")
    return m.group(1) if m else None


def num_or_default(num: Any, default: Any) -> Any:
    if isinstance(num, bool) or not isinstance(num, (int, float)):
        return default
    if isinstance(num, float) and num != num:  # NaN
        return default
    return num


def safe_parse(s: Any) -> Any:
    try:
        return json.loads(s)
    except (TypeError, ValueError):
        return None


def map_uniq(items: Iterable[Any], fn) -> List[Any]:
    seen = {}
    for item in items:
        seen[fn(item)] = None
    return list(seen.keys())


def null_logger() -> logging.Logger:
    logger = logging.getLogger("ringpop_tpu_torch.null")
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger
