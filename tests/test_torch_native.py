"""The port's native FarmHash32 oracle (``ops/native.py`` over its own copy
of ``_native/farmhash.cc``) against the JAX package's ``native`` and the
port's pure-Python ``farmhash32``: addresses, ``addr+i`` replica strings,
the real checksum strings of an n=64 cluster, every length class, and
the published goldens.  A failed build raises (no fallback to the
pure-Python hash).  Equality is exact."""

from __future__ import annotations

import random

import numpy as np
import pytest

from ringpop_tpu.ops import native as jnative
from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.models.sim.cluster import SimCluster, default_addresses
from ringpop_tpu_torch.ops import farmhash32 as fh
from ringpop_tpu_torch.ops import native
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

ADDRESSES = default_addresses(64) + ["10.0.%d.%d:%d" % (i, i * 7 % 256, 20000 + i)
                                     for i in range(32)]
GOLDEN_EMPTY = 0xDC56D17A


def _checksum_strings(n=64, ticks=12):
    sim = SimCluster(n=n, params=engine.SimParams(n=n, checksum_mode="farmhash"), device="cpu")
    sim.bootstrap()
    sim.kill([5, 9])
    for _ in range(ticks):
        sim.step()
    return [sim.checksum_string_of(i) for i in range(n)]


@pytest.fixture(scope="module")
def checksum_strings():
    return _checksum_strings()


def test_golden_and_addresses():
    assert native.hash32("") == GOLDEN_EMPTY == native.hash32(b"")
    for a in ADDRESSES:
        want = fh.hash32(a)
        assert native.hash32(a) == want == jnative.hash32(a), a


def test_replica_strings_equal_jax_and_python():
    for a in ADDRESSES[:20]:
        got = native.replica_hashes(a, 100)
        assert got.dtype == np.uint32 and got.shape == (100,)
        np.testing.assert_array_equal(got, jnative.replica_hashes(a, 100))
        np.testing.assert_array_equal(
            got, np.array([fh.hash32("%s%d" % (a, i)) for i in range(100)], np.uint32))


def test_long_replica_name_stays_native():
    # past the C entry point's 480-byte buffer the port hashes string by
    # string, still natively
    name = "x" * 600
    got = native.replica_hashes(name, 12)
    np.testing.assert_array_equal(
        got, np.array([fh.hash32(name + str(i)) for i in range(12)], np.uint32))
    np.testing.assert_array_equal(got, jnative.replica_hashes(name, 12))


def test_checksum_strings_n64(checksum_strings):
    assert len(set(checksum_strings)) >= 2  # the kill split the views
    mat, lens = fh.encode_rows(checksum_strings)
    got = native.hash32_batch(mat, lens)
    np.testing.assert_array_equal(got, fh.hash32_batch(mat, lens))
    np.testing.assert_array_equal(got, jnative.hash32_batch(mat, lens))
    assert [native.hash32(s) for s in checksum_strings] == [int(x) for x in got]


def test_every_length_class_equal_python():
    rng = random.Random(0xBEEF)
    strs = [bytes(rng.randrange(256) for _ in range(n)) for n in range(0, 80) for _ in range(8)]
    strs += [bytes([0xFF]) * n for n in range(1, 64)]
    mat, lens = fh.encode_rows(strs)
    got = native.hash32_batch(mat, lens)
    np.testing.assert_array_equal(got, fh.hash32_batch(mat, lens))
    for s, h in zip(strs[::7], got[::7]):
        assert native.hash32(s) == int(h)


def test_batch_rejects_bad_lens():
    with pytest.raises(ValueError, match="exceed"):
        native.hash32_batch(np.zeros((2, 8), np.uint8), np.array([4, 9]))


def test_library_goes_to_the_build_dir():
    native.get_lib()
    path = native._lib_path()
    assert path.parent == native.BUILD and path.exists()
    assert path.parent.name == "_build" and path.parent.parent.name == "ringpop_tpu_torch"


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeBuildError, match="not found"):
        native.hash32("127.0.0.1:3000")
    with pytest.raises(native.NativeBuildError):
        native.replica_hashes("127.0.0.1:3000", 4)
    # a compiler that runs and fails raises too, with its message
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(native.NativeBuildError, match="failed"):
        native.get_lib()
    assert not list((tmp_path / "_build").glob("*.so"))
