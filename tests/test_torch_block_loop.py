"""The port's FarmHash32 block loop and ``hash32_rows`` against the JAX
package, bit for bit (no tolerance: all uint32 arithmetic).

- ``block_loop_plain`` (and the ``block_loop`` wrapper on CPU tensors)
  against the two Pallas kernels of ``ringpop_tpu/ops/pallas_farmhash.py``
  run in interpret mode, as tests/ops/test_jax_farmhash.py runs them, at
  row counts that are not a multiple of 32 or 128, I in {1, 7, 20} and
  trip counts 0, I and in between;
- ``hash32_rows`` against JAX ``hash32_rows`` with the scan lowering and
  both Pallas loops, on rows of every length bucket with bytes >= 0x80,
  and the published goldens;
- on the card (marked ``cuda``; skipped without one), the kernel against
  its plain version, on a contiguous and on a row-strided block view.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ringpop_tpu.ops import jax_farmhash as jfh
from ringpop_tpu.ops import pallas_farmhash as jpf
from ringpop_tpu_torch.ops import block_loop as pbl
from ringpop_tpu_torch.ops import farmhash as pfh
from ringpop_tpu_torch.ops import farmhash32, u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _loop_inputs(B, I, seed):
    rng = np.random.default_rng(seed)
    carries = [rng.integers(0, 2**32, size=B, dtype=np.uint32) for _ in range(3)]
    blocks = rng.integers(0, 2**32, size=(B, I, 5), dtype=np.uint32)
    iters = rng.integers(0, I + 1, size=B).astype(np.int32)
    iters[:3] = (0, I, I // 2)  # the edges: no round, every round, half
    return carries, blocks, iters


def _port(carries, blocks, iters, fn):
    out = fn(*(u32.from_numpy(c) for c in carries), u32.from_numpy(blocks),
             torch.as_tensor(iters))
    return [u32.to_numpy(x) for x in out]


@pytest.mark.parametrize("B,I", [(1000, 1), (1100, 7), (1000, 20), (1100, 20)])
def test_block_loop_plain_matches_pallas_kernels(B, I):
    carries, blocks, iters = _loop_inputs(B, I, seed=B + I)
    grid = jpf.block_loop(*carries, blocks, iters, interpret=True)
    nogrid = jpf.block_loop_nogrid(*carries, blocks, iters, interpret=True)
    plain = _port(carries, blocks, iters, pbl.block_loop_plain)
    wrapper = _port(carries, blocks, iters, pbl.block_loop)  # CPU: the plain version
    for k in range(3):
        want = np.asarray(grid[k])
        assert np.array_equal(np.asarray(nogrid[k]), want)
        assert np.array_equal(plain[k], want), "carry %d" % k
        assert np.array_equal(wrapper[k], want), "carry %d" % k
    # rows with no round keep their carries
    zero = iters == 0
    assert np.array_equal(plain[0][zero], carries[0][zero])


def test_block_loop_takes_a_row_strided_view():
    """The word view of a byte matrix feeds the loop without a copy: rows
    ``row_stride >= 5*I`` words apart give the same bits as the contiguous
    blocks."""
    carries, blocks, iters = _loop_inputs(40, 6, seed=5)
    wide = np.zeros((40, 37), np.uint32)
    wide[:, :30] = blocks.reshape(40, 30)
    view = u32.from_numpy(wide)[:, :30].reshape(40, 6, 5)
    assert not view.is_contiguous() and view.stride() == (37, 5, 1)
    args = [u32.from_numpy(c) for c in carries]
    got = pbl.block_loop(*args, view, torch.as_tensor(iters))
    want = pbl.block_loop_plain(*args, u32.from_numpy(blocks), torch.as_tensor(iters))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bucket_rows(seed):
    """Rows of every length bucket (0-4, 5-12, 13-24, >= 25 bytes, up to
    several hundred), random bytes including >= 0x80, in a matrix with 4
    bytes of zero slack."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([
        np.arange(0, 30), rng.integers(25, 700, 90), [24, 25, 44, 45, 64, 65, 700],
    ]).astype(np.int32)
    width = int(lens.max()) + 4
    mat = np.zeros((len(lens), width), np.uint8)
    for i, n in enumerate(lens):
        mat[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    mat[:, 0] |= 0x80  # a high byte in every row (signed-char path of 0-4)
    for i, n in enumerate(lens):
        mat[i, n:] = 0
    return mat, lens


@pytest.mark.parametrize("seed", [0, 1])
def test_hash32_rows_matches_jax_every_bucket(seed):
    mat, lens = _bucket_rows(seed)
    assert (mat >= 0x80).any()
    want = np.asarray(jfh.hash32_rows(mat, lens, impl="scan"))
    tm, tl = torch.as_tensor(mat), torch.as_tensor(lens)
    assert np.array_equal(u32.to_numpy(pfh.hash32_rows(tm, tl, impl="plain")), want)
    assert np.array_equal(u32.to_numpy(pfh.hash32_rows(tm, tl, impl="kernel")), want)
    # and the host hash of each string
    host = np.array([farmhash32.hash32(bytes(mat[i, :n])) for i, n in enumerate(lens)],
                    np.uint32)
    assert np.array_equal(want, host)


def test_hash32_rows_matches_jax_pallas_loops():
    mat, lens = _bucket_rows(2)
    mat, lens = mat[::4], lens[::4]
    want = u32.to_numpy(pfh.hash32_rows(torch.as_tensor(mat), torch.as_tensor(lens), "plain"))
    for impl in ("pallas", "pallas_nogrid"):
        assert np.array_equal(np.asarray(jfh.hash32_rows(mat, lens, impl=impl)), want), impl


def test_hash32_goldens_and_pack_words():
    assert int(pfh.hash32_strings([""])[0]) == 0xDC56D17A
    assert int(pfh.hash32_strings([b"q" * 255])[0]) == 0x2AB28F77
    strs = [b"x" * n for n in (25, 44, 45, 64, 100, 333)] + [bytes(range(97)), b"addr-7" * 40]
    assert np.array_equal(pfh.hash32_strings(strs), farmhash32.hash32_strings(strs))
    rng = np.random.default_rng(4)
    mat = rng.integers(0, 256, (5, 19), dtype=np.uint8)
    got = u32.to_numpy(pfh.pack_words(torch.as_tensor(mat)))
    assert np.array_equal(got, np.asarray(jfh.pack_words(mat)))
    # a 4-byte-aligned contiguous matrix is reinterpreted in place
    t = torch.as_tensor(rng.integers(0, 256, (3, 16), dtype=np.uint8))
    assert pfh.pack_words(t).data_ptr() == t.data_ptr()
    # an unaligned storage offset is copied, with the same words
    base = torch.as_tensor(rng.integers(0, 256, 49, dtype=np.uint8))
    odd = base[1:].reshape(3, 16)
    assert np.array_equal(u32.to_numpy(pfh.pack_words(odd)),
                          np.asarray(jfh.pack_words(odd.numpy())))


def test_block_loop_wrapper_refuses_bad_operands():
    carries, blocks, iters = _loop_inputs(8, 3, seed=1)
    args = [u32.from_numpy(c) for c in carries]
    with pytest.raises(ValueError, match=r"\[B, I, 5\]"):
        pbl.block_loop(*args, u32.from_numpy(blocks).reshape(8, 15), torch.as_tensor(iters))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,I", [(1024, 1843), (256, 1843), (1000, 1), (1000, 7)])
def test_block_loop_kernel_equals_plain_on_card(cuda_device, B, I):
    carries, blocks, iters = _loop_inputs(B, I, seed=B * 7 + I)
    args = [u32.from_numpy(c, cuda_device) for c in carries]
    tb = u32.from_numpy(blocks, cuda_device)
    ti = torch.as_tensor(iters, device=cuda_device)
    got = pbl.block_loop(*args, tb, ti)
    want = pbl.block_loop_plain(*args, tb, ti)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the strided word view of a wider row
    wide = torch.zeros((B, 5 * I + 3), dtype=torch.int32, device=cuda_device)
    wide[:, : 5 * I] = tb.reshape(B, 5 * I)
    got = pbl.block_loop(*args, wide[:, : 5 * I].reshape(B, I, 5), ti)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="dtype"):
        pbl.block_loop(*args, tb.to(torch.int64), ti)
