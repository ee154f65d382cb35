"""The window arithmetic of the ``fused_stream`` kernel
(``ringpop_tpu_torch/csrc/fused_stream.cu``, a 16-lane group per row),
modelled in numpy and held bit for bit against ``fused_stream_plain`` and
the JAX package's ``fused_stream_xla``.

The kernel cannot run on the CPU, so this model repeats its index
arithmetic step for step: 32-member windows, lengths clamped to
[0, 4 * RW], an inclusive scan for each record's byte offset, every record
word OR-ed into a byte buffer at carry + offset, 20-byte blocks taken at
multiples of 20 bytes, the leftover words moved to the buffer's head, and
the stop once ``total_blocks`` blocks are mixed.  It also checks the
kernel's buffer bounds: nothing is written past ``5 + 32 * RW`` words,
nothing is non-zero past the tracked extent, and at most
``ceil((19 + 4 * RW) / 4)`` words are carried."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.ops import pallas_farmhash as jpf
from ringpop_tpu_torch.ops import stream_hash as psh
from ringpop_tpu_torch.ops import u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

M32 = 0xFFFFFFFF
C1, C2, MAGIC = 0xCC9E2D51, 0x1B873593, 0xE6546B64
WINDOW = 32


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & M32


def _mur(a, h):
    a = (a * C1) & M32
    a = _rotr(a, 17)
    a = (a * C2) & M32
    h ^= a
    h = _rotr(h, 19)
    return (h * 5 + MAGIC) & M32


def _mix(h, g, f, blk):
    a, b, c, d, e = blk
    nh = (h + a) & M32
    ng = (g + b) & M32
    nf = (f + c) & M32
    nh = (_mur(d, nh) + e) & M32
    ng = (_mur(c, ng) + a) & M32
    nf = (_mur((b + e * C1) & M32, nf) + d) & M32
    nf = (nf + ng) & M32
    ng = (ng + nf) & M32
    return nh, ng, nf


def window_model(h0, g0, f0, rec_words, rec_len, total_blocks):
    """The kernel's per-row walk, one row at a time (uint32 in, uint32 out)."""
    B, N, RW = rec_words.shape
    buf_w = 5 + WINDOW * RW
    carry_max = -(-(19 + 4 * RW) // 4)
    out = np.zeros((3, B), np.uint32)
    for b in range(B):
        h, g, f = int(h0[b]), int(g0[b]), int(f0[b])
        tb = int(total_blocks[b])
        buf = [0] * buf_w
        done = carry = ext = 0
        m0 = 0
        while m0 < N and done < tb:
            m = np.arange(m0, m0 + WINDOW)
            lens = np.where(m < N, rec_len[b, np.minimum(m, N - 1)], 0).clip(0, 4 * RW)
            incl = np.cumsum(lens)
            excl = incl - lens
            total = int(incl[-1])
            count = min(WINDOW, N - m0) * RW
            win = rec_words[b, m0:m0 + WINDOW].reshape(-1)
            assert win.shape[0] == count
            for k in range(count):
                r = k // RW
                off = carry + int(excl[r]) + 4 * (k - r * RW)
                v = int(win[k])
                if v:
                    wi, sh = off >> 2, (off & 3) * 8
                    buf[wi] |= (v << sh) & M32
                    if sh:
                        buf[wi + 1] |= v >> (32 - sh)
                    assert wi + (1 if sh else 0) < buf_w
            ext = max(ext, (carry + int(excl[-1]) + 4 * RW + 3) >> 2)
            assert not any(buf[ext:]), "a word past the tracked extent is set"
            avail = (carry + total) // 20
            k = min(avail, tb - done)
            for q in range(k):
                h, g, f = _mix(h, g, f, buf[5 * q:5 * q + 5])
            done += k
            if done >= tb:
                break
            keep = ext - 5 * avail
            assert 0 <= keep <= carry_max
            head = buf[5 * avail:5 * avail + keep]
            buf[:ext] = head + [0] * (ext - keep)
            ext = keep
            carry += total - 20 * avail
            assert 0 <= carry < 20
            m0 += WINDOW
        out[:, b] = (h, g, f)
    return out


def _lens_to_words(rng, lens, RW, padded=True):
    """Random record bytes, zero past each length when ``padded``."""
    B, N = lens.shape
    raw = rng.integers(1, 256, (B, N, 4 * RW), dtype=np.uint8)
    if padded:
        raw[np.arange(4 * RW)[None, None, :] >= lens[:, :, None]] = 0
    return raw.view("<u4").astype(np.uint32).reshape(B, N, RW)


def _real_tb(lens):
    total = np.maximum(lens.sum(axis=1) - 1, 0)
    return np.where(total > 24, (total - 1) // 20, 0).astype(np.int32)


def _case(name, rng):
    """(rec_words [B, N, RW] uint32, rec_len [B, N] int32, total_blocks [B])."""
    if name in ("absent", "ragged_n", "rw4", "rw16"):
        RW, N = {"absent": (9, 64), "ragged_n": (9, 45), "rw4": (4, 70), "rw16": (16, 50)}[name]
        B = 5
        lens = rng.integers(4, 4 * RW + 1, (B, N)).astype(np.int32)
        lens[rng.random((B, N)) < (0.6 if name == "absent" else 0.1)] = 0
        lens[0] = 0  # a row with every member absent
        return _lens_to_words(rng, lens, RW), lens, _real_tb(lens)
    if name == "tb_zero":
        RW, N, B = 9, 40, 6
        lens = rng.integers(0, 37, (B, N)).astype(np.int32)
        tb = _real_tb(lens)
        tb[::2] = 0  # long rows told to mix nothing
        lens[1, 1:] = 0  # one short row: total_blocks 0 by the rule
        tb[1] = _real_tb(lens)[1]
        assert tb[1] == 0
        return _lens_to_words(rng, lens, RW), lens, tb
    if name == "maximal":
        RW, N, B = 9, 64, 4
        lens = np.full((B, N), 4 * RW, np.int32)
        return _lens_to_words(rng, lens, RW), lens, _real_tb(lens)
    if name == "window_edge":
        # 20- and 25-byte records: a window holds 640 or 800 bytes, exactly
        # 32 or 40 blocks, so a block ends on every window edge
        RW, N, B = 9, 96, 4
        lens = np.where(np.arange(B)[:, None] % 2 == 0, 20, 25) * np.ones((B, N), np.int32)
        tb = _real_tb(lens)
        tb[0] = 32  # the last block ends exactly on the first window's edge
        tb[1] = 80  # ... on the second window's edge
        return _lens_to_words(rng, lens, RW), lens.astype(np.int32), tb
    if name == "beyond_stream":
        # total_blocks past what the records hold: mixing stops at the
        # last complete block
        RW, N, B = 9, 50, 3
        lens = rng.integers(0, 37, (B, N)).astype(np.int32)
        tb = _real_tb(lens) + np.array([5, 40, 1000], np.int32)
        return _lens_to_words(rng, lens, RW), lens, tb
    if name == "unpadded":
        # bytes past a record's length are OR-ed in, as the plain version does
        RW, N, B = 9, 70, 4
        lens = rng.integers(0, 37, (B, N)).astype(np.int32)
        return _lens_to_words(rng, lens, RW, padded=False), lens, _real_tb(lens)
    raise KeyError(name)


CASES = ("absent", "tb_zero", "ragged_n", "rw4", "rw16", "maximal", "window_edge",
         "beyond_stream", "unpadded")


@pytest.mark.parametrize("name", CASES)
def test_window_model_matches_plain_and_xla(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    words, lens, tb = _case(name, rng)
    B = words.shape[0]
    carries = [rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32) for _ in range(3)]
    got = window_model(*carries, words, lens, tb)
    plain = psh.fused_stream_plain(
        *(u32.from_numpy(c) for c in carries), u32.from_numpy(words),
        torch.as_tensor(lens), torch.as_tensor(tb),
    )
    xla = jpf.fused_stream_xla(
        *(jnp.asarray(c) for c in carries), jnp.asarray(words), jnp.asarray(lens),
        jnp.asarray(tb),
    )
    for k in range(3):
        assert np.array_equal(got[k], u32.to_numpy(plain[k])), ("plain", k)
        assert np.array_equal(got[k], np.asarray(xla[k])), ("xla", k)
    # the case mixes something, and leaves some carries untouched where
    # total_blocks is 0
    assert (got != np.stack(carries)).any()
    if name == "tb_zero":
        assert np.array_equal(got[:, tb == 0], np.stack(carries)[:, tb == 0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_window_model_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(sum(map(ord, name)))
    words, lens, tb = _case(name, rng)
    B = words.shape[0]
    carries = [rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32) for _ in range(3)]
    dev = torch.device("cuda")
    got = psh.fused_stream(
        *(u32.from_numpy(c, dev) for c in carries), u32.from_numpy(words, dev),
        torch.as_tensor(lens, device=dev), torch.as_tensor(tb, device=dev),
    )
    want = window_model(*carries, words, lens, tb)
    for k in range(3):
        assert np.array_equal(u32.to_numpy(got[k]), want[k]), k
