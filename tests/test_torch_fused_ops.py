"""The port's fused tick ops against the JAX package's twins, bit for bit:
``apply_updates_plain`` vs ``apply_updates_xla`` and ``pb_budget_plain``
vs ``pb_budget_xla`` on every combination of optional outputs, at n = 37
(one partial union word), 64 and 200; the toolkit's bitmask helpers; and
the CUDA kernels against the plain versions where a card is present."""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.ops import exchange as jex
from ringpop_tpu.ops import fused_apply as jfa
from ringpop_tpu.ops import fused_piggyback as jfp
from ringpop_tpu.ops import toolkit as jtk
from ringpop_tpu_torch.ops import fused_apply as pfa
from ringpop_tpu_torch.ops import fused_piggyback as pfp
from ringpop_tpu_torch.ops import toolkit as ptk
from ringpop_tpu_torch.ops import u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

SIZES = (37, 64, 200)


def _apply_fixture(n, seed=0):
    rng = np.random.default_rng(seed)

    def b(p):
        return rng.random((n, n)) < p

    def i(lo, hi):
        return rng.integers(lo, hi, (n, n)).astype(np.int32)

    st = [b(0.8), i(0, 4), i(0, 50), b(0.3), i(0, 4), i(0, 50), i(-1, n), i(0, 50), i(0, 20), i(-1, 60)]
    upd = [b(0.4), i(0, 4), i(0, 50), i(0, n), i(0, 50)]
    # self cells claiming suspect/faulty, so refutes happen
    diag = np.arange(n)
    upd[0][diag, diag] = True
    upd[1][diag, diag] = rng.integers(1, 3, n)
    union = rng.integers(0, 2**32, (n, ptk.packed_width(n)), dtype=np.uint64).astype(np.uint32)
    return st, upd, union


def _leaves_np(out):
    vals = []
    for x in out:
        if isinstance(x, tuple):
            vals.extend(_leaves_np(x))
        elif x is None:
            vals.append(None)
        else:
            vals.append(x)
    return vals


def _assert_same(port_out, jax_out):
    p, j = _leaves_np(port_out), _leaves_np(jax_out)
    assert len(p) == len(j)
    for k, (a, b) in enumerate(zip(p, j)):
        if b is None:
            assert a is None, k
            continue
        want = np.asarray(b)
        got = u32.to_numpy(a) if want.dtype == np.uint32 else a.numpy()
        assert np.array_equal(got, want), "output %d differs" % k


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize(
    "union,masks,count,refute", list(itertools.product([False, True], repeat=4))
)
def test_apply_updates_plain_matches_xla(n, union, masks, count, refute):
    st, upd, un = _apply_fixture(n, seed=n)
    kw = dict(want_masks=masks, want_count=count, want_refute=refute)
    want = jfa.apply_updates_xla(
        jfa.ApplyState(*(jnp.asarray(x) for x in st)),
        *(jnp.asarray(x) for x in upd), 41, 47,
        jnp.asarray(un) if union else None, **kw,
    )
    got = pfa.apply_updates_plain(
        pfa.ApplyState(*(torch.as_tensor(x) for x in st)),
        *(torch.as_tensor(x) for x in upd), 41, 47,
        u32.from_numpy(un) if union else None, **kw,
    )
    _assert_same(tuple(got), tuple(want))
    # on CPU tensors the kernel wrapper runs the plain version
    again = pfa.apply_updates(
        pfa.ApplyState(*(torch.as_tensor(x) for x in st)),
        *(torch.as_tensor(x) for x in upd), torch.tensor(41), torch.tensor(47),
        u32.from_numpy(un) if union else None, **kw,
    )
    _assert_same(tuple(again), tuple(want))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("with_hits,content", list(itertools.product([False, True], repeat=2)))
def test_pb_budget_plain_matches_xla(n, with_hits, content):
    rng = np.random.default_rng(n + 1)
    active = rng.random((n, n)) < 0.5
    pb = rng.integers(0, 40, (n, n)).astype(np.int32)
    nbump = rng.integers(0, 4, n).astype(np.int32)
    max_pb = rng.integers(15, 50, n).astype(np.int32)
    hits = rng.integers(0, 2, (n, n)).astype(np.int32) if with_hits else None
    want = jfp.pb_budget_xla(
        jnp.asarray(active), jnp.asarray(pb), jnp.asarray(nbump), jnp.asarray(max_pb),
        None if hits is None else jnp.asarray(hits), want_content=content,
    )
    args = (
        torch.as_tensor(active), torch.as_tensor(pb), torch.as_tensor(nbump),
        torch.as_tensor(max_pb), None if hits is None else torch.as_tensor(hits),
    )
    _assert_same(tuple(pfp.pb_budget_plain(*args, want_content=content)), tuple(want))
    _assert_same(tuple(pfp.pb_budget(*args, want_content=content)), tuple(want))


def test_overrides_table_matches_jax():
    grid = np.array(list(itertools.product(range(4), range(4), range(4), range(4))), np.int32)
    us, ui, cs, ci = grid.T
    want = np.asarray(jfa.overrides(*(jnp.asarray(x) for x in (us, ui, cs, ci))))
    got = pfa.overrides(*(torch.as_tensor(x) for x in (us, ui, cs, ci))).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cols", [1, 31, 32, 37, 64, 200])
def test_pack_bool_rows_and_popcount_match_jax(cols):
    rng = np.random.default_rng(cols)
    mask = rng.random((9, cols)) < 0.5
    mask[0] = True
    packed = ptk.pack_bool_rows(torch.as_tensor(mask))
    assert ptk.packed_width(cols) == jtk.packed_width(cols)
    want = np.asarray(jtk.pack_bool_rows(jnp.asarray(mask)))
    assert np.array_equal(u32.to_numpy(packed), want)
    assert np.array_equal(
        ptk.popcount(packed).numpy(), np.asarray(jex.popcount_u32(jnp.asarray(want)))
    )


def test_resolve_impl_and_validation():
    assert ptk.resolve_impl("k", "auto", "cuda", auto={"cuda": "kernel", "*": "plain"},
                            allowed=("kernel", "plain")) == "kernel"
    assert ptk.resolve_impl("k", "auto", "cpu", auto={"cuda": "kernel", "*": "plain"},
                            allowed=("kernel", "plain")) == "plain"
    with pytest.raises(ValueError, match="k must be auto"):
        ptk.resolve_impl("k", "bogus", "cpu", auto={"*": "plain"}, allowed=("plain",))
    st, upd, un = _apply_fixture(8)
    ast = pfa.ApplyState(*(torch.as_tensor(x) for x in st))
    with pytest.raises(ValueError, match="packed"):
        pfa.apply_updates(ast, *(torch.as_tensor(x) for x in upd), 1, 2,
                          torch.zeros((8, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="nbump"):
        pfp.pb_budget(ast.ch_active, ast.ch_pb, torch.zeros(7, dtype=torch.int32),
                      torch.zeros(8, dtype=torch.int32))


def test_twin_registry_names_real_entries():
    import importlib
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for t in ptk.TWIN_REGISTRY:
        mod = importlib.import_module("ringpop_tpu_torch.ops." + t.module)
        assert callable(getattr(mod, t.kernel_entry)) and callable(getattr(mod, t.plain_entry))
        assert os.path.exists(os.path.join(root, t.source)), t.source
        jmod, jfn = t.jax_entry.split(":")
        assert callable(getattr(importlib.import_module(jmod), jfn))
        with open(os.path.join(root, t.gate_test)) as fh:
            assert t.plain_entry in fh.read(), t.gate_test
        path, line = t.replaces.split(":")
        with open(os.path.join(root, path)) as fh:
            assert "def " in fh.read().splitlines()[int(line) - 1], t.replaces


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_kernels_equal_plain_on_card(cuda_device, n):
    st, upd, un = _apply_fixture(n, seed=n)
    ast = pfa.ApplyState(*(torch.as_tensor(x, device=cuda_device) for x in st))
    tu = [torch.as_tensor(x, device=cuda_device) for x in upd]
    union = u32.from_numpy(un, cuda_device)
    for flags in itertools.product([False, True], repeat=4):
        kw = dict(want_masks=flags[1], want_count=flags[2], want_refute=flags[3])
        u = union if flags[0] else None
        got = pfa.apply_updates(ast, *tu, 41, 47, u, **kw)
        want = pfa.apply_updates_plain(ast, *tu, 41, 47, u, **kw)
        for a, b in zip(_leaves_np(tuple(got)), _leaves_np(tuple(want))):
            assert (a is None and b is None) or torch.equal(a, b), flags
    rng = np.random.default_rng(n)
    args = [torch.as_tensor(x, device=cuda_device) for x in (
        rng.random((n, n)) < 0.5, rng.integers(0, 40, (n, n)).astype(np.int32),
        rng.integers(0, 4, n).astype(np.int32), rng.integers(15, 50, n).astype(np.int32),
        rng.integers(0, 2, (n, n)).astype(np.int32),
    )]
    for hits in (None, args[4]):
        got = pfp.pb_budget(*args[:4], hits)
        want = pfp.pb_budget_plain(*args[:4], hits)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
