"""The member record kernel (``csrc/member_records.cu``) against its plain
version, bit for bit.

On the CPU the wrapper runs the plain version; here its routing, its
refusals, its launch count and the ``cells_encoded`` counter are held.
On the card (marked ``cuda``; skipped without one) every output of
``member_records`` and ``member_records_at`` must equal
``member_records_plain``: every status code, incarnation 0, 1- to
19-digit values, values wider than the record's digit capacity,
negatives, absent cells, addresses of unequal widths (records whose
width is not a multiple of 4), n = 1000, 1001 and 1024, out-of-range
subjects, and the ensemble's ``[32, 1024, 1024]`` once.  Tolerance: none
(integer arithmetic and bytes).  The plain version is held against the
JAX encode in ``tests/test_torch_hash.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.func import vmap

from ringpop_tpu_torch.models.sim.cluster import default_addresses
from ringpop_tpu_torch.obs import perf
from ringpop_tpu_torch.ops import checksum_encode as ce
from ringpop_tpu_torch.ops import fused_checksum as fc

MIXED = ["127.0.0.1:%d" % (3000 + i) for i in range(13)] + ["a", "bb:1", "10.0.0.9:99"]


def _edge_incarnations():
    """0, every digit count 1..19, the int64 extremes and negatives."""
    vals = [0, 1, 9, 10, 2**63 - 1, -1, -7, -10, -(2**63)]
    vals += [10**k for k in range(19)] + [10**k - 1 for k in range(1, 19)]
    vals += [10**k + 7 for k in range(1, 19)]
    return np.asarray(vals, np.int64)


def _cells(shape, seed):
    """(present, status, inc_ms) over ``shape``: every status code (and -1),
    the edge incarnations spread over the cells, the rest 13-digit
    epoch-ms values, a fifth of the cells absent."""
    rng = np.random.default_rng(seed)
    size = int(np.prod(shape))
    inc = rng.integers(10**12, 2 * 10**12, size)
    vals = _edge_incarnations()
    at = rng.choice(size, min(size, 4 * len(vals)), replace=False)
    inc[at] = np.resize(vals, len(at))
    status = rng.choice(np.asarray([0, 1, 2, 3, -1], np.int32), size)
    present = rng.random(size) < 0.8
    return tuple(torch.as_tensor(a.reshape(shape)) for a in (present, status, inc))


def _to(dev, *ts):
    return tuple(t.to(dev) for t in ts)


def test_member_records_runs_the_plain_version_on_the_cpu():
    uni = ce.Universe.from_addresses(MIXED)
    present, status, inc = _cells((5, uni.n), seed=1)
    before = fc.member_records.launches
    for got, want in zip(fc.member_records(uni, present, status, inc, 14),
                         fc.member_records_plain(uni, present, status, inc, 14)):
        assert torch.equal(got, want)
    subject = torch.arange(-3, 5 * uni.n - 3).reshape(5, uni.n)
    for got, want in zip(fc.member_records_at(uni, subject, status, inc, present, 14),
                         fc.member_records_plain(uni, present, status, inc, 14,
                                                 subject=subject)):
        assert torch.equal(got, want)
    assert fc.member_records.launches == before


def test_cells_encoded_counts_every_cluster_without_a_device_read():
    uni = ce.Universe.from_addresses(default_addresses(20))
    present, status, inc = _cells((3, 4, uni.n), seed=2)
    subject = torch.zeros((3, 7), dtype=torch.int64)
    fc.member_records(uni, present[0], status[0], inc[0])  # no span log: no count
    timer = perf.DispatchTimer()
    with perf.tracing(timer):
        fc.member_records(uni, present[0], status[0], inc[0])
        assert timer.counters["cells_encoded"] == 4 * uni.n
        fc.member_records_at(uni, subject[0], status[0, 0, :7], inc[0, 0, :7],
                             present[0, 0, :7])
        assert timer.counters["cells_encoded"] == 4 * uni.n + 7
        vmap(lambda p, s, i: fc.member_records(uni, p, s, i))(present, status, inc)
        assert timer.counters["cells_encoded"] == 4 * uni.n + 7 + 3 * 4 * uni.n


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    uni = ce.Universe.from_addresses(default_addresses(20))
    width = fc.record_width(uni, 14)
    _, addr_len, addr_words = fc._universe_tables(uni, width, torch.device("cpu"))
    present, status, inc = _cells((2, uni.n + 1), seed=3)
    with pytest.raises(ValueError, match="expected"):
        fc._launch(present, status, inc, None, addr_len, addr_words, 14, width)
    present, status, inc = _cells((2, uni.n), seed=3)
    with pytest.raises(ValueError, match="digits"):
        fc._launch(present, status, inc, None, addr_len, addr_words, 0, width)
    wide = ce.Universe.from_addresses(["h" * 120 + str(i) for i in range(3)])
    w2 = fc.record_width(wide, 14)
    _, l2, aw2 = fc._universe_tables(wide, w2, torch.device("cpu"))
    present, status, inc = _cells((2, 3), seed=3)
    with pytest.raises(ValueError, match="at most 128 bytes"):
        fc._launch(present, status, inc, None, l2, aw2, 14, w2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1001, 1024])
@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_member_records_kernel_equals_plain_on_card(cuda_device, n, form):
    uni = ce.Universe.from_addresses(default_addresses(n))
    present, status, inc = _to(cuda_device, *_cells((3, n), seed=n))
    before = fc.member_records.launches
    if form == "dense":
        got = fc.member_records(uni, present, status, inc, 14)
        want = fc.member_records_plain(uni, present, status, inc, 14)
    else:
        # every member once, and subjects outside [0, n) (clamped)
        subject = torch.arange(-5, 3 * n - 5, device=cuda_device).reshape(3, n) % (n + 10) - 5
        got = fc.member_records_at(uni, subject, status, inc, present, 14)
        want = fc.member_records_plain(uni, present, status, inc, 14, subject=subject)
    torch.cuda.synchronize()
    assert fc.member_records.launches - before == 1
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("max_digits", [1, 13, 14, 19])
def test_member_records_kernel_unequal_address_widths_on_card(cuda_device, max_digits):
    """Mixed-width addresses, records of 23, 35, 36 and 41 bytes (the
    kernel's byte path, and its 16-byte path at 36), a ragged last block."""
    uni = ce.Universe.from_addresses(MIXED)
    present, status, inc = _to(cuda_device, *_cells((37, uni.n), seed=max_digits))
    _same(fc.member_records(uni, present, status, inc, max_digits),
          fc.member_records_plain(uni, present, status, inc, max_digits))
    subject = torch.arange(present.numel(), device=cuda_device).reshape(present.shape) % uni.n
    _same(fc.member_records_at(uni, subject, status, inc, present, max_digits),
          fc.member_records_plain(uni, present, status, inc, max_digits, subject=subject))


@pytest.mark.cuda
def test_member_records_kernel_full_ensemble_shape_on_card(cuda_device):
    """The b32 ensemble's encode, [32, 1024, 1024] cells, once."""
    n = 1024
    uni = ce.Universe.from_addresses(default_addresses(n))
    present, status, inc = _to(cuda_device, *_cells((32, n, n), seed=32))
    got = fc.member_records(uni, present, status, inc, 14)
    torch.cuda.synchronize()
    want = fc.member_records_plain(uni, present, status, inc, 14)
    _same(got, want)
