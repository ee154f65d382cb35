"""The port's checksum-string encoders against the JAX package, byte for
byte: ``membership_rows`` (both scatter forms, chunked and not, with 14 and
19 incarnation digits) and ``ring_rows``, on views with every status,
absent members and incarnations of every digit count from 1 to
``max_digits``; the buffers and the lengths must be equal, and each row
must be the reference's checksum string."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.ops import checksum_encode as jce
from ringpop_tpu_torch.ops import checksum_encode as pce
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


def test_gather_encoders_are_not_ported():
    _, up, present, status, inc = _views(14)
    for impl in ("gather", "gather2"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            pce.membership_rows(up, torch.as_tensor(present), torch.as_tensor(status),
                                torch.as_tensor(inc), impl=impl)
