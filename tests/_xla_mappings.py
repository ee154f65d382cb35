"""Keeps a test process under the kernel's limit on memory mappings, and
its torch CPU ops on one thread.

An XLA CPU executable keeps its compiled code in memory mappings until it
is dropped, and a test worker keeps every executable it has compiled.
Past the kernel's limit (``vm.max_map_count``, 65,530 by default) the
next compile fails to allocate and the worker dies ("Segmentation fault"
or "Aborted"), taking the test it was running with it.  A full run of the
suite brings a worker within a few thousand mappings of the limit.  The
port's test modules import :func:`bounded_mappings`: a process already
past ``MAPPINGS_HIGH`` drops every executable it holds before such a
module starts, and JAX compiles again (from its persistent cache, where
it has one) what later tests need.

Importing this module also sets torch's intra-op pool to one thread.  The
suite runs in several worker processes on one machine, and torch's default
pool is one thread a core in every worker: their threads outnumber the
cores several times over and wait on each other, and the port's plain
versions, which run many small ops, slow down several times.  Integer
results do not depend on the pool; the one float mean sums in a fixed
order.
"""

from __future__ import annotations

import gc

import jax
import pytest
import torch

torch.set_num_threads(1)

MAPPINGS_HIGH = 40_000


def mappings() -> int:
    """The memory mappings of this process (0 where there is no /proc)."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def drop_executables() -> None:
    jax.clear_caches()
    gc.collect()  # jitted closures of dropped objects sit in cycles


@pytest.fixture(scope="module", autouse=True)
def bounded_mappings():
    if mappings() > MAPPINGS_HIGH:
        drop_executables()
