"""The kernel wrappers' batching rules, and the two repairs the batch axis
needed.

Under ``torch.func.vmap`` every kernel wrapper routes its batched operands
through a ``torch.library.custom_op`` whose ``register_vmap`` rule runs all
B clusters at once: one launch on the card, the plain version over the
stacked (or row-flattened) operands on the CPU.  Here, on the CPU, ``vmap``
of each wrapper over B=3 must equal the per-cluster plain calls stacked,
with an unbatched operand (``in_dims=None``), per-cluster stamps that
differ, and every output option on and off.  On the card (marked ``cuda``;
skipped without one) the batched launch must equal B single-cluster
launches and the plain version, and count one launch.

The repairs: ``exchange.delta_sum_plain`` builds its result out of place
(so it runs under vmap), and ``engine_scalable._prp_perm`` walks B rows
together under vmap, one host read a step, while the solo walk keeps its
host-read count.  Tolerance: none (integer arithmetic throughout).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch
from torch.func import vmap

from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.cluster import default_addresses
from ringpop_tpu_torch.ops import block_loop as pbl
from ringpop_tpu_torch.ops import checksum_encode as pce
from ringpop_tpu_torch.ops import exchange as pex
from ringpop_tpu_torch.ops import fused_apply as pfa
from ringpop_tpu_torch.ops import fused_checksum as pfc
from ringpop_tpu_torch.ops import fused_piggyback as pfp
from ringpop_tpu_torch.ops import prp_walk as pprp
from ringpop_tpu_torch.ops import stream_hash as psh
from ringpop_tpu_torch.ops import toolkit, u32

B = 3


def _i32(a, dev):
    return torch.as_tensor(np.asarray(a).astype(np.int64).astype(np.uint32).view(np.int32),
                           device=dev)


def _apply_inputs(b, n, seed, dev="cpu"):
    rng = np.random.default_rng(seed)

    def bp():
        return torch.as_tensor(rng.random((b, n, n)) < 0.5, device=dev)

    def ip(lo, hi):
        return torch.as_tensor(rng.integers(lo, hi, (b, n, n)).astype(np.int32), device=dev)

    planes = (bp(), ip(0, 4), ip(0, 9), bp(), ip(0, 4), ip(0, 9), ip(-1, n), ip(0, 9),
              ip(0, 40), ip(-1, 40))
    upd = (bp(), ip(0, 4), ip(0, 12), ip(0, n), ip(0, 9))
    union = _i32(rng.integers(0, 2**32, (b, n, toolkit.packed_width(n))), dev)
    now = torch.tensor([5, 8, 11][:b] + [3] * max(0, b - 3), dtype=torch.int32, device=dev)
    return planes, upd, union, now, now + 25


def _apply_tuple(out):
    return tuple(x for x in (*out.state, out.union, out.applied, out.applied_rows,
                             out.applied_count, out.refute_diag) if x is not None)


APPLY_FLAGS = list(itertools.product([False, True], repeat=4))


@pytest.mark.parametrize("union,masks,count,refute", APPLY_FLAGS)
def test_apply_updates_rule_equals_stacked_plain(union, masks, count, refute):
    planes, upd, un, now, dl = _apply_inputs(B, 40, seed=1)
    kw = dict(want_masks=masks, want_count=count, want_refute=refute)

    def one(*a):
        return _apply_tuple(pfa.apply_updates(pfa.ApplyState(*a[:10]), *a[10:15], a[15], a[16],
                                              a[17] if union else None, **kw))

    got = vmap(one)(*planes, *upd, now, dl, un)
    for i in range(B):
        want = _apply_tuple(pfa.apply_updates_plain(
            pfa.ApplyState(*(p[i] for p in planes)), *(u[i] for u in upd), int(now[i]),
            int(dl[i]), un[i] if union else None, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    if count:  # applied_count comes back per cluster
        assert got[-2 if refute else -1].shape == (B,)


def test_apply_updates_rule_with_unbatched_operands():
    """A shared update plane (``in_dims=None``) and Python-int stamps."""
    planes, upd, _, _, _ = _apply_inputs(B, 33, seed=2)
    shared = upd[3][0]

    def one(*a):
        return _apply_tuple(pfa.apply_updates(pfa.ApplyState(*a[:10]), *a[10:13], shared, a[13],
                                              7, 30, want_count=True))

    got = vmap(one)(*planes, *upd[:3], upd[4])
    for i in range(B):
        want = _apply_tuple(pfa.apply_updates_plain(
            pfa.ApplyState(*(p[i] for p in planes)), *(u[i] for u in upd[:3]), shared,
            upd[4][i], 7, 30, want_count=True))
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


def _budget_inputs(b, n, seed, dev="cpu"):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (t(rng.random((b, n, n)) < 0.6), t(rng.integers(0, 40, (b, n, n)).astype(np.int32)),
            t(rng.integers(-1, 5, (b, n)).astype(np.int32)),
            t(rng.integers(15, 45, (b, n)).astype(np.int32)),
            t(rng.integers(0, 3, (b, n, n)).astype(np.int32)))


@pytest.mark.parametrize("hits,content", list(itertools.product([False, True], repeat=2)))
def test_pb_budget_rule_equals_stacked_plain(hits, content):
    active, pb, nbump, max_pb, h = _budget_inputs(B, 37, seed=3)
    shared_max = max_pb[0]  # an unbatched operand
    fn = lambda a, p, nb, hh: tuple(x for x in pfp.pb_budget(  # noqa: E731
        a, p, nb, shared_max, hh if hits else None, want_content=content) if x is not None)
    got = vmap(fn)(active, pb, nbump, h)
    assert got[-1].shape == (B,)  # drops per cluster
    for i in range(B):
        want = [x for x in pfp.pb_budget_plain(active[i], pb[i], nbump[i], shared_max,
                                               h[i] if hits else None, want_content=content)
                if x is not None]
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


def _stream_inputs(b, rows, n, rw, seed, dev="cpu"):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 4 * rw + 1, (b, rows, n)).astype(np.int32)
    raw = rng.integers(1, 256, (b, rows, n, 4 * rw), dtype=np.uint8)
    raw[np.arange(4 * rw)[None, None, None, :] >= lens[..., None]] = 0
    words = raw.view("<u4").reshape(b, rows, n, rw)
    total = np.maximum(lens.sum(axis=2) - 1, 0)
    tb = np.where(total > 24, (total - 1) // 20, 0).astype(np.int32)
    carries = [_i32(rng.integers(0, 2**32, (b, rows)), dev) for _ in range(3)]
    return (*carries, _i32(words, dev), torch.as_tensor(lens, device=dev),
            torch.as_tensor(tb, device=dev))


def test_fused_stream_rule_equals_stacked_plain():
    args = _stream_inputs(B, 5, 23, 9, seed=4)
    got = vmap(psh.fused_stream)(*args)
    for i in range(B):
        want = psh.fused_stream_plain(*(a[i] for a in args))
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    # one universe's record words shared by every cluster (in_dims None)
    fn = lambda h, g, f, ln, tb: psh.fused_stream(h, g, f, args[3][0], ln, tb)  # noqa: E731
    got = vmap(fn)(*args[:3], *args[4:])
    for i in range(B):
        want = psh.fused_stream_plain(args[0][i], args[1][i], args[2][i], args[3][0],
                                      args[4][i], args[5][i])
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


def _records_inputs(b, rows, n, seed, dev="cpu"):
    """B clusters' (known, status, inc_ms) views of an n-node universe,
    every status, 1- to 14-digit incarnations, and B x 40 sparse cells."""
    rng = np.random.default_rng(seed)
    shape = (b, rows, n)
    present = torch.as_tensor(rng.random(shape) < 0.8, device=dev)
    status = torch.as_tensor(rng.integers(0, 4, shape).astype(np.int32), device=dev)
    inc = torch.as_tensor(10 ** rng.integers(0, 14, shape) + rng.integers(0, 9, shape),
                          device=dev)
    subject = torch.as_tensor(rng.integers(0, n, (b, 40)), device=dev)
    return present, status, inc, subject


def test_member_records_rule_equals_stacked_plain():
    uni = pce.Universe.from_addresses(default_addresses(33))
    present, status, inc, subject = _records_inputs(B, 5, uni.n, seed=16)
    got = vmap(lambda p, s, i: pfc.member_records(uni, p, s, i, 14))(present, status, inc)
    for i in range(B):
        want = pfc.member_records_plain(uni, present[i], status[i], inc[i], 14)
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    # the sparse form, one cluster's statuses shared by every cluster
    # (in_dims None)
    cells = [t.reshape(B, -1)[:, :40] for t in (present, status, inc)]

    def sparse(subj, p, i):
        return pfc.member_records_at(uni, subj, cells[1][0], i, p, 14)

    got = vmap(sparse)(subject, cells[0], cells[2])
    for i in range(B):
        want = pfc.member_records_plain(uni, cells[0][i], cells[1][0], cells[2][i], 14,
                                        subject=subject[i])
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


def test_prp_walk_rule_equals_stacked_plain():
    n = 37  # 4^3 = 64 > 37: walks take several steps
    ids = torch.arange(n, dtype=torch.int32)
    keys = _i32(np.random.default_rng(18).integers(0, 2**32, (B, pprp.ROUNDS)), "cpu")
    for inverse in (False, True):
        got = vmap(lambda k: pprp.prp_walk(ids, k, n, inverse))(keys)
        for i in range(B):
            assert torch.equal(got[i], pprp.prp_walk_plain(ids, keys[i], n, inverse))


@pytest.mark.parametrize("layout", ["front", "moved", "nested"])
def test_bytes_to_words_under_vmap_equals_per_cluster_words(layout):
    """Record bytes whose batch axes lead contiguous storage (a batching
    rule's output) are viewed as words under vmap; any other layout is
    assembled from its bytes: the same words either way."""
    rec = torch.as_tensor(np.random.default_rng(17).integers(0, 256, (B, 5, 36), dtype=np.uint8))
    want = torch.stack([u32.bytes_to_words(rec[i]) for i in range(B)])
    if layout == "front":
        got = vmap(u32.bytes_to_words)(rec)
        assert vmap(lambda t: torch.tensor(toolkit.leads_contiguous(t)))(rec).all()
    elif layout == "moved":
        moved = rec.transpose(0, 1).contiguous()
        got = vmap(u32.bytes_to_words, in_dims=1)(moved)
        assert not vmap(lambda t: torch.tensor(toolkit.leads_contiguous(t)), in_dims=1)(moved).any()
    else:
        got = vmap(vmap(u32.bytes_to_words))(rec.reshape(B, 5, 1, 36)).reshape(want.shape)
    assert torch.equal(got, want)


def _loop_inputs(b, rows, n_iter, seed, dev="cpu"):
    rng = np.random.default_rng(seed)
    carries = [_i32(rng.integers(0, 2**32, (b, rows)), dev) for _ in range(3)]
    blocks = _i32(rng.integers(0, 2**32, (b, rows, n_iter, 5)), dev)
    iters = torch.as_tensor(rng.integers(0, n_iter + 1, (b, rows)).astype(np.int32), device=dev)
    return (*carries, blocks, iters)


def test_block_loop_rule_equals_stacked_plain():
    args = _loop_inputs(B, 6, 7, seed=5)
    got = vmap(pbl.block_loop)(*args)
    # the plain version itself under vmap runs every round (no host read)
    plain_vmapped = vmap(pbl.block_loop_plain)(*args)
    for i in range(B):
        want = pbl.block_loop_plain(*(a[i] for a in args))
        for g, p, w in zip(got, plain_vmapped, want):
            assert torch.equal(g[i], w) and torch.equal(p[i], w)
    # a row-strided view of wider rows (the batched word view of checksum
    # rows), and one block set shared by every cluster
    wide = _i32(np.random.default_rng(6).integers(0, 2**32, (B, 6, 7 * 5 + 3)), "cpu")
    view = wide[:, :, :35].unflatten(2, (7, 5))
    got = vmap(pbl.block_loop)(*args[:3], view, args[4])
    fn = lambda h, g, f, it: pbl.block_loop(h, g, f, view[0], it)  # noqa: E731
    shared = vmap(fn)(*args[:3], args[4])
    for i in range(B):
        want = pbl.block_loop_plain(args[0][i], args[1][i], args[2][i], view[i].contiguous(),
                                    args[4][i])
        want0 = pbl.block_loop_plain(args[0][i], args[1][i], args[2][i], view[0].contiguous(),
                                     args[4][i])
        for g, s, w, w0 in zip(got, shared, want, want0):
            assert torch.equal(g[i], w) and torch.equal(s[i], w0)


def _exchange_inputs(b, n, w, seed, dev="cpu"):
    rng = np.random.default_rng(seed)
    planes = [_i32(rng.integers(0, 2**32, (b, n, w)) & rng.integers(0, 2**32, (b, n, w)), dev)
              for _ in range(3)]
    return (*planes, _i32(rng.integers(0, 2**32, (b, w * 32)), dev))


@pytest.mark.parametrize("shared,counts", list(itertools.product([False, True], repeat=2)))
def test_exchange_rule_equals_stacked_plain(shared, counts):
    heard, pulled, pushed, delta = _exchange_inputs(B, 45, 3, seed=7)
    absent = []

    def fn(h, pl, ps, d):
        out = pex.exchange(h, pl, ps, delta[0] if shared else d, want_counts=counts)
        absent.append(out[2] is None)
        return out[:2] if out[2] is None else out

    got = vmap(fn, in_dims=(0, 0, 0, None if shared else 0))(heard, pulled, pushed, delta)
    assert absent == [not counts] and len(got) == (3 if counts else 2)
    for i in range(B):
        want = pex.exchange_plain(heard[i], pulled[i], pushed[i], delta[0 if shared else i],
                                  want_counts=counts)
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


def _stacked(outs):
    return tuple(torch.stack(list(xs)) for xs in zip(*outs))


@pytest.mark.parametrize("kernel", ["apply_updates", "pb_budget", "exchange_shared_table",
                                    "exchange_own_tables", "pack_bool_rows"])
def test_plain_versions_take_a_batch_axis(kernel):
    """The plain versions a batching rule runs on the CPU take the stacked
    ``[B, ...]`` operands directly (per-cluster stamps, tables, counts and
    drops): equal to the per-cluster calls stacked."""
    if kernel == "apply_updates":
        planes, upd, un, now, dl = _apply_inputs(B, 35, seed=12)
        kw = dict(want_masks=True, want_count=True, want_refute=True)
        got = _apply_tuple(pfa.apply_updates_plain(pfa.ApplyState(*planes), *upd, now, dl, un,
                                                   **kw))
        want = _stacked([_apply_tuple(pfa.apply_updates_plain(
            pfa.ApplyState(*(p[i] for p in planes)), *(u[i] for u in upd), now[i], dl[i], un[i],
            **kw)) for i in range(B)])
    elif kernel == "pb_budget":
        ops = _budget_inputs(B, 29, seed=13)
        got = tuple(pfp.pb_budget_plain(*ops))
        want = _stacked([tuple(pfp.pb_budget_plain(*(t[i] for t in ops))) for i in range(B)])
    elif kernel == "pack_bool_rows":
        mask = torch.as_tensor(np.random.default_rng(14).random((B, 9, 70)) < 0.5)
        got = (toolkit.pack_bool_rows(mask),)
        want = _stacked([(toolkit.pack_bool_rows(mask[i]),) for i in range(B)])
    else:
        heard, pulled, pushed, delta = _exchange_inputs(B, 41, 3, seed=15)
        shared = kernel == "exchange_shared_table"
        got = pex.exchange_plain(heard, pulled, pushed, delta[0] if shared else delta,
                                 _chunk_rows=10)
        want = _stacked([pex.exchange_plain(heard[i], pulled[i], pushed[i],
                                            delta[0 if shared else i]) for i in range(B)])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_delta_sum_plain_under_vmap_equals_per_row_loop():
    words, _, _, delta = _exchange_inputs(B, 50, 2, seed=8)
    got = vmap(lambda d, t: pex.delta_sum_plain(d, t, _chunk_rows=7))(words, delta)
    for i in range(B):
        tbl = u32.to_numpy(delta[i]).astype(np.uint64)
        wn = u32.to_numpy(words[i])
        rows = [int(sum(int(tbl[w * 32 + bit]) for w in range(wn.shape[1]) for bit in range(32)
                        if (int(wn[r, w]) >> bit) & 1)) & 0xFFFFFFFF for r in range(wn.shape[0])]
        assert np.array_equal(u32.to_numpy(got[i]), np.asarray(rows, np.uint32))


def _walk_steps(key, n, salt, inverse):
    """Walk steps of the solo cycle walk, counted outside the engine."""
    hb = pprp.half_bits(n)
    keys = pes._rand_u32(key, (pprp.ROUNDS,), salt)
    x = pprp.feistel(torch.arange(n, dtype=torch.int32), keys, hb, inverse)
    steps = 0
    while bool(u32.uge(x, n).any()):
        x = torch.where(u32.uge(x, n), pprp.feistel(x, keys, hb, inverse), x)
        steps += 1
    return steps


@pytest.mark.parametrize("inverse", [False, True])
def test_prp_perm_batched_walk_equals_solo_walks(inverse):
    n, salt = 37, 0xA11CE  # 4^3 = 64 > 37: walks take several steps
    keys = _i32(np.random.default_rng(9).integers(0, 2**32, (4, 2)), "cpu")
    steps = [_walk_steps(k, n, salt, inverse) for k in keys]
    assert max(steps) > 1
    solo = []
    for k, st in zip(keys, steps):
        before = pes.host_read.count
        solo.append(pes._prp_perm(k, n, salt, inverse))
        # the solo walk keeps one host read a step (and the final check)
        assert pes.host_read.count - before == st + 1
        assert sorted(solo[-1].tolist()) == list(range(n))
    before = pes.host_read.count
    got = vmap(lambda k: pes._prp_perm(k, n, salt, inverse))(keys)
    # the batched walk reads once a step for all rows: until the slowest row
    assert pes.host_read.count - before == max(steps) + 1
    for i in range(len(keys)):
        assert torch.equal(got[i], solo[i])


def test_every_kernel_has_a_batching_rule():
    """Each TWIN_REGISTRY row's kernel has its custom op, registered with
    a batching rule, and the row names the gate test that holds the
    rule."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for twin in toolkit.TWIN_REGISTRY:
        op = getattr(torch.ops.ringpop_torch, twin.kernel_entry)
        assert op.default is not None
        path = os.path.join(root, twin.batch_gate_test)
        assert os.path.exists(path)
        with open(path) as fh:
            assert "test_%s_rule_equals_stacked_plain" % twin.kernel_entry in fh.read()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batched_launches_equal_single_launches_on_card(cuda_device):
    """One launch for B clusters, bitwise equal to B single launches."""
    dev = cuda_device
    planes, upd, un, now, dl = _apply_inputs(4, 1001, seed=11, dev=dev)
    before = pfa.apply_updates.launches
    got = vmap(lambda *a: _apply_tuple(pfa.apply_updates(
        pfa.ApplyState(*a[:10]), *a[10:15], a[15], a[16], a[17], want_masks=True,
        want_count=True)))(*planes, *upd, now, dl, un)
    assert pfa.apply_updates.launches - before == 1
    for i in range(4):
        st = pfa.ApplyState(*(p[i] for p in planes))
        args = (st, *(u[i] for u in upd), now[i], dl[i], un[i])
        kw = dict(want_masks=True, want_count=True)
        for g, s, w in zip(got, _apply_tuple(pfa.apply_updates(*args, **kw)),
                           _apply_tuple(pfa.apply_updates_plain(*args, **kw))):
            assert torch.equal(g[i], s) and torch.equal(s, w)
    active, pb, nbump, max_pb, h = _budget_inputs(4, 1001, seed=12, dev=dev)
    before = pfp.pb_budget.launches
    got = vmap(lambda *a: tuple(pfp.pb_budget(*a)))(active, pb, nbump, max_pb, h)
    assert pfp.pb_budget.launches - before == 1
    for i in range(4):
        want = pfp.pb_budget_plain(active[i], pb[i], nbump[i], max_pb[i], h[i])
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    for fn, plain, args in (
        (psh.fused_stream, psh.fused_stream_plain, _stream_inputs(4, 16, 200, 9, 13, dev)),
        (pbl.block_loop, pbl.block_loop_plain, _loop_inputs(4, 100, 7, 14, dev)),
    ):
        before = fn.launches
        got = vmap(fn)(*args)
        assert fn.launches - before == 1
        for i in range(4):
            for g, w in zip(got, plain(*(a[i] for a in args))):
                assert torch.equal(g[i], w)
    uni = pce.Universe.from_addresses(default_addresses(1001))
    present, status, inc, subject = _records_inputs(4, 3, 1001, 16, dev)
    before = pfc.member_records.launches
    got = vmap(lambda p, s, i: pfc.member_records(uni, p, s, i, 14))(present, status, inc)
    sparse = vmap(lambda su, p, s, i: pfc.member_records_at(uni, su, s, i, p, 14))(
        subject, present[:, 0, :40], status[:, 0, :40], inc[:, 0, :40])
    assert pfc.member_records.launches - before == 2
    for i in range(4):
        single = pfc.member_records(uni, present[i], status[i], inc[i], 14)
        for g, s, w in zip(got, single, pfc.member_records_plain(uni, present[i], status[i],
                                                                 inc[i], 14)):
            assert torch.equal(g[i], s) and torch.equal(s, w)
        want = pfc.member_records_plain(uni, present[i, 0, :40], status[i, 0, :40],
                                        inc[i, 0, :40], 14, subject=subject[i])
        for g, w in zip(sparse, want):
            assert torch.equal(g[i], w)
    ids = torch.arange(100_000, dtype=torch.int32, device=dev)
    keys = _i32(np.random.default_rng(19).integers(0, 2**32, (4, pprp.ROUNDS)), dev)
    before = pprp.prp_walk.launches
    got = vmap(lambda k: pprp.prp_walk(ids, k, 100_000, False))(keys)
    assert pprp.prp_walk.launches - before == 1
    for i in range(4):
        single = pprp.prp_walk(ids, keys[i], 100_000, False)
        assert torch.equal(got[i], single)
        assert torch.equal(single, pprp.prp_walk_plain(ids, keys[i], 100_000, False))
    heard, pulled, pushed, delta = _exchange_inputs(4, 100_001, 16, 15, dev)
    before = pex.exchange.launches
    got = vmap(pex.exchange)(heard, pulled, pushed, delta)
    assert pex.exchange.launches - before == 1
    for i in range(4):
        for g, w in zip(got, pex.exchange_plain(heard[i], pulled[i], pushed[i], delta[i])):
            assert torch.equal(g[i], w)
