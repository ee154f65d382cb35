"""The port's FarmHash32 pieces against the published goldens and the JAX
package, bit for bit: the host copy, the short-string buckets, record_mix,
the record encoder and packer, the stream hash and fused_hash_rows."""

from __future__ import annotations

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.ops import checksum_encode as jce
from ringpop_tpu.ops import fused_checksum as jfc
from ringpop_tpu.ops import jax_farmhash as jfh
from ringpop_tpu.ops import pallas_farmhash as jpf
from ringpop_tpu.ops.record_mix import record_mix as jax_record_mix
from ringpop_tpu_torch.ops import checksum_encode as pce
from ringpop_tpu_torch.ops import farmhash as pfh
from ringpop_tpu_torch.ops import farmhash32
from ringpop_tpu_torch.ops import fused_checksum as pfc
from ringpop_tpu_torch.ops import stream_hash as psh
from ringpop_tpu_torch.ops import u32
from ringpop_tpu_torch.ops.record_mix import record_mix
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _goldens():
    path = os.path.join(os.path.dirname(__file__), "ops", "test_farmhash_goldens.py")
    spec = importlib.util.spec_from_file_location("_farmhash_goldens", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GOLDENS


GOLDENS = _goldens()


def test_host_farmhash32_copy_matches_goldens():
    assert farmhash32.hash32("") == 0xDC56D17A
    for data, want in GOLDENS:
        assert farmhash32.hash32(data) == want, data
    mat, lens = farmhash32.encode_rows([d for d, _ in GOLDENS])
    assert np.array_equal(
        farmhash32.hash32_batch(mat, lens), np.array([w for _, w in GOLDENS], np.uint32)
    )


def test_record_mix_matches_jax():
    rng = np.random.default_rng(0)
    subj = rng.integers(0, 4096, (64, 64), dtype=np.int32)
    st = rng.integers(0, 4, (64, 64), dtype=np.int32)
    inc = rng.integers(0, 2**31 - 1, (64, 64), dtype=np.int32)
    want = np.asarray(jax_record_mix(jnp.asarray(subj), jnp.asarray(st), jnp.asarray(inc)))
    got = record_mix(torch.as_tensor(subj), torch.as_tensor(st), torch.as_tensor(inc))
    assert np.array_equal(u32.to_numpy(got), want)


def test_short_buckets_match_jax():
    rng = np.random.default_rng(1)
    B = 512
    mat = rng.integers(0, 256, (B, 28), dtype=np.uint8)  # bytes >= 0x80 too
    lens = rng.integers(0, 25, B).astype(np.int32)
    jm, jl = jnp.asarray(mat), jnp.asarray(lens)
    tm, tl = torch.as_tensor(mat), torch.as_tensor(lens)
    for jf, pf in ((jfh._hash_0_4, pfh._hash_0_4), (jfh._hash_5_12, pfh._hash_5_12),
                   (jfh._hash_13_24, pfh._hash_13_24)):
        assert np.array_equal(u32.to_numpy(pf(tm, tl)), np.asarray(jf(jm, jl))), pf.__name__
    x = u32.from_numpy(rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32))
    jx = jnp.asarray(u32.to_numpy(x))
    assert np.array_equal(u32.to_numpy(pfh._fmix(x)), np.asarray(jfh._fmix(jx)))
    assert np.array_equal(u32.to_numpy(pfh._mur(x, x * 3)), np.asarray(jfh._mur(jx, jx * np.uint32(3))))


def _views(seed=3):
    """A universe of mixed-width addresses and an adversarial view batch:
    empty rows, single members (5-12 and 13-24 byte strings), every
    status, incarnation digit counts 1..14, absent members, long rows."""
    addrs = ["127.0.0.1:%d" % (3000 + i) for i in range(13)] + ["a", "bb:1", "10.0.0.9:99"]
    uni_j = jce.Universe.from_addresses(addrs)
    uni_p = pce.Universe.from_addresses(addrs)
    n = uni_j.n
    rng = np.random.default_rng(seed)
    B = 24
    present = rng.random((B, n)) > 0.3
    present[0] = True
    present[1] = False  # empty row: 0 bytes
    for r, m in ((2, 0), (3, 1), (4, 2), (5, n - 1)):  # single members
        present[r] = False
        present[r, m] = True
    present[6] = False
    present[6, [0, 1]] = True  # "a" + "bb:1": two short records
    status = rng.integers(0, 4, (B, n))
    status[7] = 3
    inc = rng.integers(1, 10**14, (B, n))
    for d in range(1, 15):  # every digit count 1..14
        inc[7 + d % 16, :] = 10 ** (d - 1) + d
    inc[8, :5] = 0  # zero incarnation: one digit
    inc[2:6] = rng.integers(0, 10, (4, n))  # short strings
    return uni_j, uni_p, present, status, inc


@pytest.mark.parametrize("max_digits", [14, 19])
def test_member_records_and_packing_match_jax(max_digits):
    uni_j, uni_p, present, status, inc = _views()
    assert pfc.record_width(uni_p, max_digits) == jfc.record_width(uni_j, max_digits)
    jb, jl = jfc.member_records(
        uni_j, jnp.asarray(present), jnp.asarray(status), jnp.asarray(inc), max_digits
    )
    pb, pl = pfc.member_records(
        uni_p, torch.as_tensor(present), torch.as_tensor(status), torch.as_tensor(inc), max_digits
    )
    assert np.array_equal(pb.numpy(), np.asarray(jb))
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    assert np.array_equal(
        u32.to_numpy(pfc.pack_record_words(pb)), np.asarray(jfc.pack_record_words(jb))
    )
    # the sparse form on arbitrary cells
    rng = np.random.default_rng(9)
    subj = rng.integers(0, uni_j.n, 300).astype(np.int32)
    st, ic, pr = status.reshape(-1)[:300], inc.reshape(-1)[:300], present.reshape(-1)[:300]
    jb2, jl2 = jfc.member_records_at(
        uni_j, jnp.asarray(subj), jnp.asarray(st), jnp.asarray(ic), jnp.asarray(pr), max_digits
    )
    pb2, pl2 = pfc.member_records_at(
        uni_p, torch.as_tensor(subj), torch.as_tensor(st), torch.as_tensor(ic),
        torch.as_tensor(pr), max_digits,
    )
    assert np.array_equal(pb2.numpy(), np.asarray(jb2))
    assert np.array_equal(pl2.numpy(), np.asarray(jl2))


def _edge_incarnations():
    """0, every digit count 1..19, the int64 extremes and negatives."""
    vals = [0, 1, 9, 10, 2**63 - 1, -1, -7, -10, -(2**63)]
    vals += [10**k for k in range(19)] + [10**k - 1 for k in range(1, 19)]
    vals += [10**k + 7 for k in range(1, 19)]
    return np.asarray(vals, np.int64)


@pytest.mark.parametrize("max_digits", [1, 14, 19])
def test_member_records_plain_matches_jax_on_edge_cells(max_digits):
    """``member_records_plain`` (the record kernel's oracle) in both forms
    against the JAX encode: every status code (and -1, which both tables
    wrap to 3), incarnation 0, 1- to 19-digit values, values wider than
    ``max_digits``, negatives, absent cells, addresses of unequal widths."""
    uni_j, uni_p, _, _, _ = _views()
    n = uni_j.n
    vals = _edge_incarnations()
    codes = np.asarray([0, 1, 2, 3, -1], np.int32)
    inc = np.broadcast_to(vals[:, None], (len(vals), n)).copy()
    status = codes[(np.arange(len(vals))[:, None] + np.arange(n)[None, :]) % len(codes)]
    present = (np.arange(len(vals))[:, None] + 2 * np.arange(n)[None, :]) % 7 != 0
    jb, jl = jfc.member_records(
        uni_j, jnp.asarray(present), jnp.asarray(status), jnp.asarray(inc), max_digits
    )
    pb, pl = pfc.member_records_plain(
        uni_p, torch.as_tensor(present), torch.as_tensor(status), torch.as_tensor(inc), max_digits
    )
    assert np.array_equal(pb.numpy(), np.asarray(jb))
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    subj = np.random.default_rng(5).integers(0, n, inc.size).astype(np.int32)
    flat = [a.reshape(-1) for a in (status, inc, present)]
    jb2, jl2 = jfc.member_records_at(uni_j, *(jnp.asarray(a) for a in (subj, *flat)), max_digits)
    pb2, pl2 = pfc.member_records_plain(
        uni_p, torch.as_tensor(flat[2]), torch.as_tensor(flat[0]), torch.as_tensor(flat[1]),
        max_digits, subject=torch.as_tensor(subj),
    )
    assert np.array_equal(pb2.numpy(), np.asarray(jb2))
    assert np.array_equal(pl2.numpy(), np.asarray(jl2))


def test_fused_stream_plain_matches_fused_stream_xla():
    uni_j, uni_p, present, status, inc = _views(4)
    jb, jl = jfc.member_records(uni_j, jnp.asarray(present), jnp.asarray(status), jnp.asarray(inc), 14)
    words = jfc.pack_record_words(jb)
    rng = np.random.default_rng(5)
    B = present.shape[0]
    carries = [rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32) for _ in range(3)]
    total = np.maximum(np.asarray(jl).sum(axis=1) - 1, 0)
    tb = np.where(total > 24, (total - 1) // 20, 0).astype(np.int32)
    want = jpf.fused_stream_xla(*(jnp.asarray(c) for c in carries), words, jl, jnp.asarray(tb))
    got = psh.fused_stream_plain(
        *(u32.from_numpy(c) for c in carries),
        u32.from_numpy(np.asarray(words)),
        torch.as_tensor(np.array(jl)),
        torch.as_tensor(tb),
    )
    for g, w in zip(got, want):
        assert np.array_equal(u32.to_numpy(g), np.asarray(w))
    # on a CPU tensor the kernel wrapper runs the plain version
    again = psh.fused_stream(
        *(u32.from_numpy(c) for c in carries),
        u32.from_numpy(np.asarray(words)),
        torch.as_tensor(np.array(jl)),
        torch.as_tensor(tb),
    )
    for g, w in zip(again, want):
        assert np.array_equal(u32.to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("seed", [3, 11, 12])
def test_fused_hash_rows_matches_jax_and_host(seed):
    uni_j, uni_p, present, status, inc = _views(seed)
    jb, jl = jfc.member_records(uni_j, jnp.asarray(present), jnp.asarray(status), jnp.asarray(inc), 14)
    want = np.asarray(jfc.fused_hash_rows(jfc.pack_record_words(jb), jl, impl="xla"))
    pb, pl = pfc.member_records(
        uni_p, torch.as_tensor(present), torch.as_tensor(status), torch.as_tensor(inc), 14
    )
    got = u32.to_numpy(pfc.fused_hash_rows(pfc.pack_record_words(pb), pl, impl="plain"))
    assert np.array_equal(got, want)
    # and against the host hash of the assembled checksum strings
    lens = pl.numpy()
    strings = []
    for b in range(present.shape[0]):
        parts = [bytes(pb[b, j, : lens[b, j]].numpy()) for j in range(uni_p.n) if lens[b, j]]
        strings.append(b"".join(parts)[:-1] if parts else b"")
    assert {len(s) <= 4 for s in strings} == {True, False}
    assert any(4 < len(s) <= 12 for s in strings) and any(12 < len(s) <= 24 for s in strings)
    assert np.array_equal(got, np.array([farmhash32.hash32(s) for s in strings], np.uint32))


@pytest.mark.cuda
def test_fused_stream_kernel_equals_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    uni_j, uni_p, present, status, inc = _views(4)
    dev = torch.device("cuda")
    pb, pl = pfc.member_records(
        uni_p, torch.as_tensor(present, device=dev), torch.as_tensor(status, device=dev),
        torch.as_tensor(inc, device=dev), 14,
    )
    words = pfc.pack_record_words(pb)
    got = pfc.fused_hash_rows(words, pl, impl="kernel")
    want = pfc.fused_hash_rows(words, pl, impl="plain")
    assert torch.equal(got, want)
