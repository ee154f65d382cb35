"""The port's fused push-pull exchange against the JAX op, bit for bit.

Seeded numpy masks go through the port's ``exchange_plain`` (and the
``exchange`` wrapper, which runs it on CPU tensors), the JAX package's
pure-XLA twin ``exchange_xla`` and its Pallas kernel in interpret mode.
Every output — the new mask, the per-row delta sum mod 2^32 and the
optional new-bit count — must be equal; tolerance none (integer
arithmetic).  The row deltas are also held against the JAX engine's
``_bit_delta_sum``, the limb-matmul formulation the incremental checksum
uses.  The CUDA kernel itself runs only on the card (``cuda`` marker).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.ops import exchange as jex
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.ops import exchange as pex
from ringpop_tpu_torch.ops import u32

SHAPES = [(1, 1), (64, 4), (1025, 4), (100, 3)]


def _masks(n, w, seed):
    """heard plus sparse pulled/pushed rows, and a full-range delta table."""
    rng = np.random.default_rng(seed)

    def words(p):
        bits = rng.random((n, w, 32)) < p
        return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)

    heard, pulled, pushed = words(0.5), words(0.2), words(0.2)
    r_delta = rng.integers(0, 2**32, w * 32, dtype=np.uint64).astype(np.uint32)
    return heard, pulled, pushed, r_delta


def _port(arrays):
    return [u32.from_numpy(a) for a in arrays]


def _np(t):
    return None if t is None else (u32.to_numpy(t) if t.dtype == torch.int32 else t.numpy())


@pytest.mark.parametrize("want_counts", [True, False])
@pytest.mark.parametrize("n,w", SHAPES)
def test_plain_equals_xla_twin_and_pallas_interpret(n, w, want_counts):
    arrays = _masks(n, w, seed=n * 7 + w)
    new, acc, cnt = pex.exchange_plain(*_port(arrays), want_counts=want_counts)
    jargs = [jnp.asarray(a) for a in arrays]
    for impl in ("xla", "pallas"):
        kw = {"interpret": True} if impl == "pallas" else {}
        jn, ja, jc = jex.exchange(*jargs, impl=impl, want_counts=want_counts, **kw)
        assert np.array_equal(_np(new), np.asarray(jn)), impl
        assert np.array_equal(_np(acc), np.asarray(ja)), impl
        if want_counts:
            assert cnt.dtype == torch.int32
            assert np.array_equal(cnt.numpy(), np.asarray(jc)), impl
        else:
            assert cnt is None and jc is None
    assert new.dtype == acc.dtype == torch.int32


@pytest.mark.parametrize("n,w", SHAPES)
def test_row_delta_equals_engine_bit_delta_sum(n, w):
    heard, pulled, pushed, r_delta = _masks(n, w, seed=n + w)
    _, acc, _ = pex.exchange_plain(*_port((heard, pulled, pushed, r_delta)))
    diff = (heard | pulled | pushed) ^ heard
    want = jes._bit_delta_sum(jnp.asarray(diff), jnp.asarray(r_delta), w * 32)
    assert np.array_equal(_np(acc), np.asarray(want))
    # the port engine's own reduction, with a chunk that splits the rows
    got = pes._bit_delta_sum(u32.from_numpy(diff), u32.from_numpy(r_delta), _chunk_rows=7)
    assert np.array_equal(_np(got), np.asarray(want))


def test_wrapper_on_cpu_runs_the_plain_version():
    arrays = _port(_masks(33, 2, seed=5))
    before = pex.exchange.launches
    got = pex.exchange(*arrays)
    want = pex.exchange_plain(*arrays)
    assert pex.exchange.launches == before  # no kernel launch on the CPU
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_exchange_local_equals_jax():
    arrays = _masks(96, 4, seed=11)
    new, acc = pex.exchange_local(*_port(arrays), impl="plain")
    jn, ja = jex.exchange_local(*[jnp.asarray(a) for a in arrays], impl="xla")
    assert np.array_equal(_np(new), np.asarray(jn))
    assert np.array_equal(_np(acc), np.asarray(ja))
    with pytest.raises(ValueError, match="kernel|plain"):
        pex.exchange_local(*_port(arrays), impl="xla")


def test_popcount_and_host_math_equal_jax():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:3] = (0, 0xFFFFFFFF, 0x80000000)
    assert np.array_equal(
        pex.popcount_u32(u32.from_numpy(x)).numpy(), np.asarray(jex.popcount_u32(jnp.asarray(x)))
    )
    for n, w in ((1_000_000, 16), (4096, 16), (100, 3)):
        assert pex.step_traffic_bytes(n, w) == jex.step_traffic_bytes(n, w)
    for rows, shards in ((1, 1), (250_000, 4), (16, 4), (100, 7), (1000, 1)):
        assert pex.exchange_cap(rows, shards) == jex.exchange_cap(rows, shards)


def test_wrapper_rejects_a_short_delta_table():
    heard, pulled, pushed, r_delta = _port(_masks(8, 2, seed=1))
    with pytest.raises(ValueError, match="delta table"):
        pex.exchange(heard, pulled, pushed, r_delta[:32])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", SHAPES + [(1000, 16), (1000, 40)])
def test_kernel_equals_plain_on_card(cuda_device, n, w):
    arrays = [u32.from_numpy(a, cuda_device) for a in _masks(n, w, seed=n + w)]
    for want_counts in (True, False):
        got = pex.exchange(*arrays, want_counts=want_counts)
        want = pex.exchange_plain(*arrays, want_counts=want_counts)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b), (n, w, want_counts)
