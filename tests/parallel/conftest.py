"""Mesh tests run with the persistent XLA compilation cache turned off.

On jax/jaxlib 0.9.0, a multi-device XLA:CPU executable that is loaded
back from the persistent cache (tests/conftest.py keeps one in
`.jax_cache/`) can deadlock in its own collectives: the 8 device threads
stop at different all-reduce / all-gather rendezvous and the process
aborts after the 40 s collective timeout.  A cold compile of the same
program runs fine, so a warm cache from an earlier run is enough to turn
the sharded storm tests (ShardedStorm over an 8-device mesh) into
aborts.  Every test in this folder therefore compiles fresh and writes
nothing to the cache; the rest of the suite keeps it.
"""

import jax
import pytest
from jax.experimental.compilation_cache import compilation_cache as cc


@pytest.fixture(autouse=True)
def _no_persistent_compilation_cache():
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()  # the cache memoizes whether it is in use
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        cc.reset_cache()
