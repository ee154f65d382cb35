"""The partner permutation's cycle walk (``ops/prp_walk.py``): the plain
version against the JAX engine's ``_prp_perm`` on the CPU, the engine's
walk against the plain version, and on the card (marked ``cuda``, no JAX)
the kernel (``csrc/prp_walk.cu``) against the plain version, bitwise,
with no host read."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.ops import prp_walk as prp

SALT = 0xA11CE
KEYS = ((0x12345678, 0x9ABCDEF0), (7, 0xFFFFFFFE))


def _jax_perm(a, b, n, inverse):
    import jax.numpy as jnp

    from ringpop_tpu.models.sim import engine_scalable as jes

    return np.asarray(jes._prp_perm(jnp.asarray(np.array([a, b], np.uint32)), n, SALT,
                                    inverse=inverse))


def _pkey(a, b, dev="cpu"):
    return torch.as_tensor(np.array([a, b], np.uint32).view(np.int32), device=dev)


def _round_keys(a, b, dev="cpu"):
    return pes._rand_u32(_pkey(a, b, dev), (prp.ROUNDS,), SALT)


@pytest.mark.parametrize("n", [1, 2, 37, 400, 4097])
def test_prp_walk_plain_equals_jax(n):
    ids = torch.arange(n, dtype=torch.int32)
    for a, b in KEYS:
        for inverse in (False, True):
            want = _jax_perm(a, b, n, inverse)
            got = prp.prp_walk_plain(ids, _round_keys(a, b), n, inverse)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want), (n, inverse)


@pytest.mark.parametrize("n", [37, 400, 100_000])
def test_half_bits_and_inverse(n):
    hb = prp.half_bits(n)
    assert 4 ** (hb - 1) < n <= 4 ** hb
    ids = torch.arange(n, dtype=torch.int32)
    keys = _round_keys(*KEYS[0])
    fwd = prp.prp_walk_plain(ids, keys, n, False)
    inv = prp.prp_walk_plain(ids, keys, n, True)
    assert torch.equal(torch.sort(fwd).values, ids)
    assert torch.equal(inv[fwd.long()], ids)


def test_engine_walk_on_the_cpu_equals_plain_at_a_shards_ids():
    n = 400
    key = _pkey(*KEYS[1])
    keys = pes._rand_u32(key, (prp.ROUNDS,), SALT)
    ids = torch.arange(150, 275, dtype=torch.int32)
    for inverse in (False, True):
        got = pes.run_solo(pes._prp_walk_rows(key, ids, n, SALT, inverse))
        assert torch.equal(got, prp.prp_walk_plain(ids, keys, n, inverse))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 400, 100_000, 1_000_000])
def test_prp_walk_kernel_equals_plain_on_card(cuda_device, n):
    dev = cuda_device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(n)
    keys = torch.as_tensor(rng.integers(0, 2**32, (3, prp.ROUNDS), dtype=np.uint32)
                           .view(np.int32), device=dev)
    for inverse in (False, True):
        before = prp.prp_walk.launches
        got = prp.prp_walk(ids, keys, n, inverse)
        assert prp.prp_walk.launches - before == 1
        assert torch.equal(got, prp.prp_walk_plain(ids, keys, n, inverse))
        one = prp.prp_walk(ids[n // 3:], keys[1], n, inverse)
        assert torch.equal(one, got[1, n // 3:])


@pytest.mark.cuda
def test_engine_perm_on_card_reads_nothing_and_equals_the_cpu(cuda_device):
    n = 100_000
    for a, b in KEYS:
        for inverse in (False, True):
            before = pes.host_read.count
            got = pes._prp_perm(_pkey(a, b, cuda_device), n, SALT, inverse)
            assert pes.host_read.count == before
            assert torch.equal(got.cpu(), pes._prp_perm(_pkey(a, b), n, SALT, inverse))
