"""The port's checksum-string encoders against the JAX package, byte for
byte: ``membership_rows`` (both scatter forms, chunked and not, with 14 and
19 incarnation digits; both gather forms at several digit counts and
widths, against JAX's and against ``scatter_unique``) and ``ring_rows``,
on views with every status, absent members and incarnations of every
digit count from 1 to ``max_digits``; the buffers and the lengths must be
equal, and each row must be the reference's checksum string.  Also
``record_word_width`` and ``membership_checksums`` against JAX's, the
latter equal to ``hash32_rows`` of every encoder's rows."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.ops import checksum_encode as jce
from ringpop_tpu.ops import fused_checksum as jfc
from ringpop_tpu_torch.ops import checksum_encode as pce
from ringpop_tpu_torch.ops import farmhash as pfh
from ringpop_tpu_torch.ops import fused_checksum as pfc
from ringpop_tpu_torch.ops import u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

ADDRS = ["127.0.0.1:%d" % (3000 + i) for i in range(13)] + ["a", "bb:1", "10.0.0.9:99"]


def _views(max_digits, seed=0):
    uj, up = jce.Universe.from_addresses(ADDRS), pce.Universe.from_addresses(ADDRS)
    n = up.n
    rng = np.random.default_rng(seed)
    B = 3 * max_digits + 6
    present = rng.random((B, n)) > 0.25
    present[0] = False  # an empty row
    present[1] = True
    present[2] = False
    present[2, 5] = True  # a single member
    status = rng.integers(0, 4, (B, n)).astype(np.int32)
    status[3] = np.arange(n) % 4  # every status in one row
    inc = rng.integers(0, 10 ** (max_digits - 1), (B, n)).astype(np.int64)
    for d in range(1, max_digits + 1):  # every digit count, several rows each
        inc[4 + d] = 10 ** (d - 1) + np.arange(n) % 7
        inc[4 + max_digits + d, ::2] = min(10 ** d - 1, 2**63 - 1)  # the widest d-digit
    inc[1, :4] = 0  # zero incarnation: one digit
    return uj, up, present, status, inc


def _strings(up, present, status, inc):
    out = []
    for b in range(present.shape[0]):
        parts = ["%s%s%d" % (up.addresses[j], pce.STATUS_STRINGS[status[b, j]], inc[b, j])
                 for j in range(up.n) if present[b, j]]
        out.append(";".join(parts).encode())
    return out


@pytest.mark.parametrize("max_digits", [14, 19])
@pytest.mark.parametrize("impl", ["scatter_unique", "scatter"])
@pytest.mark.parametrize("chunk", [64, 8])
def test_membership_rows_match_jax(max_digits, impl, chunk):
    uj, up, present, status, inc = _views(max_digits, seed=max_digits)
    assert up.member_row_width(max_digits) == uj.member_row_width(max_digits)
    jb, jl = jce.membership_rows(uj, jnp.asarray(present), jnp.asarray(status),
                                 jnp.asarray(inc), max_digits=max_digits, chunk=chunk, impl=impl)
    pb, pl = pce.membership_rows(up, torch.as_tensor(present), torch.as_tensor(status),
                                 torch.as_tensor(inc), max_digits=max_digits, chunk=chunk,
                                 impl=impl)
    assert pb.dtype == torch.uint8 and pl.dtype == torch.int32
    assert np.array_equal(pb.numpy(), np.asarray(jb))
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    for b, s in enumerate(_strings(up, present, status, inc)):
        assert int(pl[b]) == len(s) and bytes(pb[b, : len(s)].numpy()) == s, b
        # the last member's ';' lies just past the length, then zeros
        assert not pb[b, len(s) + 1:].any()


def test_ring_rows_match_jax():
    uj, up, present, _, _ = _views(14, seed=3)
    assert up.ring_row_width() == uj.ring_row_width()
    jb, jl = jce.ring_rows(uj, jnp.asarray(present))
    pb, pl = pce.ring_rows(up, torch.as_tensor(present))
    assert np.array_equal(pb.numpy(), np.asarray(jb))
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    for b in range(present.shape[0]):
        s = ";".join(a for j, a in enumerate(up.addresses) if present[b, j]).encode()
        assert bytes(pb[b, : len(s)].numpy()) == s


@pytest.mark.parametrize("max_digits,extra", [(14, 0), (19, 0), (14, 13), (6, 5)])
@pytest.mark.parametrize("impl", ["gather", "gather2"])
def test_gather_encoders_match_jax_and_scatter(max_digits, extra, impl):
    """The gather encoders' buffers and lengths equal JAX's bitwise (the
    default width and a wider buffer; chunked at 8 rows), and their first
    ``lens`` bytes equal ``scatter_unique``'s: past them the gather forms
    hold zeros where the scatter forms keep the final ';'."""
    uj, up, present, status, inc = _views(max_digits, seed=max_digits + extra)
    width = up.member_row_width(max_digits) + extra if extra else None
    chunk = 8 if extra else 64
    jb, jl = jce.membership_rows(uj, jnp.asarray(present), jnp.asarray(status),
                                 jnp.asarray(inc), max_digits=max_digits, width=width,
                                 chunk=chunk, impl=impl)
    args = (up, torch.as_tensor(present), torch.as_tensor(status), torch.as_tensor(inc))
    pb, pl = pce.membership_rows(*args, max_digits=max_digits, width=width, chunk=chunk,
                                 impl=impl)
    assert pb.dtype == torch.uint8 and pl.dtype == torch.int32
    assert np.array_equal(pb.numpy(), np.asarray(jb))
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    sb, sl = pce.membership_rows(*args, max_digits=max_digits, width=width, chunk=chunk)
    assert torch.equal(pl, sl) and pb.shape == sb.shape
    for b, s in enumerate(_strings(up, present, status, inc)):
        assert int(pl[b]) == len(s) and bytes(pb[b, : len(s)].numpy()) == s, b
        assert torch.equal(pb[b, : len(s)], sb[b, : len(s)]) and not pb[b, len(s):].any()


def test_unknown_encoder_is_refused():
    _, up, present, status, inc = _views(6)
    with pytest.raises(ValueError, match="gather2"):
        pce.membership_rows(up, torch.as_tensor(present), torch.as_tensor(status),
                            torch.as_tensor(inc), impl="bisect")


@pytest.mark.parametrize("max_digits", [6, 14, 19])
def test_record_word_width_matches_jax(max_digits):
    uj, up = jce.Universe.from_addresses(ADDRS), pce.Universe.from_addresses(ADDRS)
    assert pfc.record_word_width(up, max_digits) == jfc.record_word_width(uj, max_digits)
    assert pfc.record_word_width(up, max_digits) == -(-pfc.record_width(up, max_digits) // 4)


def _checksum_views(max_digits=14):
    uj, up, present, status, inc = _views(max_digits, seed=40 + max_digits)
    return uj, (up, torch.as_tensor(present), torch.as_tensor(status), torch.as_tensor(inc))


def test_membership_checksums_match_jax():
    """``membership_checksums`` (the plain stream hash on the CPU, as
    ``impl=None`` picks here) equals JAX's."""
    uj, args = _checksum_views()
    want = np.asarray(jfc.membership_checksums(uj, *(jnp.asarray(a.numpy()) for a in args[1:]),
                                               14, impl="xla"))
    got = pfc.membership_checksums(*args, 14)
    assert got.dtype == torch.int32
    assert np.array_equal(u32.to_numpy(got), want)
    assert torch.equal(got, pfc.membership_checksums(*args, 14, impl="plain"))


@pytest.mark.parametrize("max_digits", [14, 19])
@pytest.mark.parametrize("impl", ["scatter_unique", "scatter", "gather", "gather2"])
def test_membership_checksums_equal_hash_rows_of_every_encoder(max_digits, impl):
    _, args = _checksum_views(max_digits)
    rows = pce.membership_rows(*args, max_digits=max_digits, impl=impl)
    assert torch.equal(pfh.hash32_rows(*rows), pfc.membership_checksums(*args, max_digits))
