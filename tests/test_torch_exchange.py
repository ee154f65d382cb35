"""The port's fused push-pull exchange against the JAX op, bit for bit.

Seeded numpy masks go through the port's ``exchange_plain`` (and the
``exchange`` wrapper, which runs it on CPU tensors), the JAX package's
pure-XLA twin ``exchange_xla`` and its Pallas kernel in interpret mode.
Every output — the new mask, the per-row delta sum mod 2^32 and the
optional new-bit count — must be equal; tolerance none (integer
arithmetic).  The row deltas are also held against the JAX engine's
``_bit_delta_sum``, the limb-matmul formulation the incremental checksum
uses.  The CUDA kernel itself runs only on the card (``cuda`` marker);
here its launch plan (``exchange_plan``) and a numpy model of its grid
walk (persistent blocks, row tiles, lanes of 1 or 4 words, the row's
lanes summed) are held against the same outputs.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.ops import exchange as jex
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.ops import exchange as pex
from ringpop_tpu_torch.ops import u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

SHAPES = [(1, 1), (64, 4), (1025, 4), (100, 3)]


def _masks(n, w, seed):
    """heard plus sparse pulled/pushed rows, and a full-range delta table."""
    rng = np.random.default_rng(seed)

    def words(p):
        bits = rng.random((n, w, 32)) < p
        return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)

    heard, pulled, pushed = words(0.5), words(0.2), words(0.2)
    r_delta = rng.integers(0, 2**32, w * 32, dtype=np.uint64).astype(np.uint32)
    return heard, pulled, pushed, r_delta


def _port(arrays):
    return [u32.from_numpy(a) for a in arrays]


def _np(t):
    return None if t is None else (u32.to_numpy(t) if t.dtype == torch.int32 else t.numpy())


@pytest.mark.parametrize("want_counts", [True, False])
@pytest.mark.parametrize("n,w", SHAPES)
def test_plain_equals_xla_twin_and_pallas_interpret(n, w, want_counts):
    arrays = _masks(n, w, seed=n * 7 + w)
    new, acc, cnt = pex.exchange_plain(*_port(arrays), want_counts=want_counts)
    jargs = [jnp.asarray(a) for a in arrays]
    for impl in ("xla", "pallas"):
        kw = {"interpret": True} if impl == "pallas" else {}
        jn, ja, jc = jex.exchange(*jargs, impl=impl, want_counts=want_counts, **kw)
        assert np.array_equal(_np(new), np.asarray(jn)), impl
        assert np.array_equal(_np(acc), np.asarray(ja)), impl
        if want_counts:
            assert cnt.dtype == torch.int32
            assert np.array_equal(cnt.numpy(), np.asarray(jc)), impl
        else:
            assert cnt is None and jc is None
    assert new.dtype == acc.dtype == torch.int32


@pytest.mark.parametrize("n,w", SHAPES)
def test_row_delta_equals_engine_bit_delta_sum(n, w):
    heard, pulled, pushed, r_delta = _masks(n, w, seed=n + w)
    _, acc, _ = pex.exchange_plain(*_port((heard, pulled, pushed, r_delta)))
    diff = (heard | pulled | pushed) ^ heard
    want = jes._bit_delta_sum(jnp.asarray(diff), jnp.asarray(r_delta), w * 32)
    assert np.array_equal(_np(acc), np.asarray(want))
    # the port engine's own reduction, with a chunk that splits the rows
    got = pes._bit_delta_sum(u32.from_numpy(diff), u32.from_numpy(r_delta), _chunk_rows=7)
    assert np.array_equal(_np(got), np.asarray(want))


def test_wrapper_on_cpu_runs_the_plain_version():
    arrays = _port(_masks(33, 2, seed=5))
    before = pex.exchange.launches
    got = pex.exchange(*arrays)
    want = pex.exchange_plain(*arrays)
    assert pex.exchange.launches == before  # no kernel launch on the CPU
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_exchange_local_equals_jax():
    arrays = _masks(96, 4, seed=11)
    new, acc = pex.exchange_local(*_port(arrays), impl="plain")
    jn, ja = jex.exchange_local(*[jnp.asarray(a) for a in arrays], impl="xla")
    assert np.array_equal(_np(new), np.asarray(jn))
    assert np.array_equal(_np(acc), np.asarray(ja))
    with pytest.raises(ValueError, match="kernel|plain"):
        pex.exchange_local(*_port(arrays), impl="xla")


def test_popcount_and_host_math_equal_jax():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:3] = (0, 0xFFFFFFFF, 0x80000000)
    assert np.array_equal(
        pex.popcount_u32(u32.from_numpy(x)).numpy(), np.asarray(jex.popcount_u32(jnp.asarray(x)))
    )
    for n, w in ((1_000_000, 16), (4096, 16), (100, 3)):
        assert pex.step_traffic_bytes(n, w) == jex.step_traffic_bytes(n, w)
    for rows, shards in ((1, 1), (250_000, 4), (16, 4), (100, 7), (1000, 1)):
        assert pex.exchange_cap(rows, shards) == jex.exchange_cap(rows, shards)


def test_wrapper_rejects_a_short_delta_table():
    heard, pulled, pushed, r_delta = _port(_masks(8, 2, seed=1))
    with pytest.raises(ValueError, match="delta table"):
        pex.exchange(heard, pulled, pushed, r_delta[:32])


@pytest.mark.parametrize(
    "w,aligned,vec",
    [(16, True, 4), (4, True, 4), (8, True, 4), (2048, True, 4),
     (1, True, 1), (3, True, 1), (40, True, 1), (16, False, 1), (2048, False, 1)],
)
def test_plan_lane_width(w, aligned, vec):
    plan = pex.exchange_plan(1_000_000, w, aligned, sm_count=132)
    assert plan.vec == vec
    assert plan.seg <= 32 and plan.seg & (plan.seg - 1) == 0
    assert plan.rows_per_tile * plan.seg == pex.THREADS
    # a row's lanes cover its words: seg lanes x (items a lane takes) x vec
    per_lane = -(-(w // plan.vec) // plan.seg)
    assert plan.seg * per_lane * plan.vec >= w
    if plan.vec == 4:
        assert w % (4 * plan.seg) == 0  # 4-word lanes leave no lane idle


@pytest.mark.parametrize(
    "n,w,vec",
    [(1000, 16, 1), (1000, 4, 1), (1025, 4, 1), (4096, 16, 1), (1000, 512, 4), (1000, 2048, 4),
     (33_792, 16, 4), (100_001, 16, 4), (100_001, 8, 4), (200_001, 4, 4)],
)
def test_plan_takes_4_word_lanes_where_they_fill_the_card(n, w, vec):
    """Below a full grid of 4-word tiles, 4-byte lanes where they make more
    tiles (more threads, each walking one word); at w = 512 and 2048 a row
    spans a warp either way, so the tiles are the same and 4-word lanes
    stay."""
    plan = pex.exchange_plan(n, w, True, sm_count=132)
    assert plan.vec == vec
    wide = pex.exchange_plan(10**8, w, True, sm_count=132)
    assert wide.vec == 4


def test_plan_takes_scalar_lanes_for_a_view_off_16_bytes():
    n, w = 64, 16
    base = torch.zeros(n * w + 1, dtype=torch.int32)
    assert base.data_ptr() % 16 == 0
    view = base[1:].view(n, w)  # 4 bytes past an aligned allocation
    assert not pex._aligned(view, view, view)
    assert pex.exchange_plan(10**6, w, pex._aligned(view, view, view), 132).vec == 1
    shifted = torch.zeros(n + 1, w, dtype=torch.int32)[1:]  # heard[1:]: 64 bytes in
    assert pex.exchange_plan(10**6, w, pex._aligned(shifted, shifted, shifted), 132).vec == 4


@pytest.mark.parametrize("w", [1, 3, 16, 40, 2048])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 1_000_000])
def test_plan_tiles_cover_rows(n, w):
    for sm_count in (1, 132):
        plan = pex.exchange_plan(n, w, True, sm_count)
        assert plan.tiles * plan.rows_per_tile >= n > (plan.tiles - 1) * plan.rows_per_tile
        assert 1 <= plan.blocks <= plan.tiles
        assert plan.blocks <= sm_count * pex.BLOCKS_PER_SM
    assert plan.smem_table == (w * 32 * 4 <= 227 * 1024)


def test_plan_blocks_fit_the_tables_shared_memory():
    # a 64 KB table (w = 512) leaves room for three blocks an SM, a 2 KB one
    # for the full residency
    assert pex.exchange_plan(10**6, 512, True, 132).blocks == 132 * 3
    assert pex.exchange_plan(10**6, 16, True, 132).blocks == 132 * pex.BLOCKS_PER_SM
    assert pex.exchange_plan(10**6, 1816, True, 132).blocks == 132  # 227 KB: one a block
    assert not pex.exchange_plan(10**6, 1817, True, 132).smem_table


def _grid_model(heard, pulled, pushed, r_delta, plan):
    """``csrc/exchange.cu``'s walk in numpy: each block takes tiles
    blockIdx, blockIdx + blocks, ...; in a tile, thread t is lane t % seg of
    row t // seg and takes items k = 0 .. per_lane - 1, each ``vec`` words
    from word (k * seg + lane) * vec; a row's lanes are summed at its last
    item.  Returns (new, row_delta, new_bits, visits per word)."""
    n, w = heard.shape
    tbl = r_delta.astype(np.uint64)
    new = np.zeros_like(heard)
    acc = np.zeros(n, np.uint64)
    cnt = np.zeros(n, np.int64)
    visits = np.zeros((n, w), np.int64)
    per_lane = -(-(w // plan.vec) // plan.seg)
    thread = np.arange(pex.THREADS)
    lane, tile_row = thread % plan.seg, thread // plan.seg
    bit_idx = np.arange(32)
    bit = bit_idx.astype(np.uint64)
    for block in range(plan.blocks):
        for tile in range(block, plan.tiles, plan.blocks):
            rows = tile * plan.rows_per_tile + tile_row
            part_acc = np.zeros(pex.THREADS, np.uint64)
            part_cnt = np.zeros(pex.THREADS, np.int64)
            for k in range(per_lane):
                word0 = (k * plan.seg + lane) * plan.vec
                valid = (rows < n) & (word0 < w)
                assert (word0[valid] + plan.vec <= w).all()  # a lane's words stay in its row
                if plan.vec == 4:  # 16-byte lanes
                    assert ((rows[valid] * w + word0[valid]) % 4 == 0).all()
                r = rows[valid]
                for j in range(plan.vec):
                    c = word0[valid] + j
                    h = heard[r, c]
                    nw = h | pulled[r, c] | pushed[r, c]
                    new[r, c] = nw
                    visits[r, c] += 1
                    bits = (nw ^ h).astype(np.uint64)[:, None] >> bit & 1
                    part_acc[valid] += (bits * tbl[c[:, None] * 32 + bit_idx]).sum(1)
                    part_cnt[valid] += bits.sum(1).astype(np.int64)
            row_acc = part_acc.reshape(plan.rows_per_tile, plan.seg).sum(1) & 0xFFFFFFFF
            row_cnt = part_cnt.reshape(plan.rows_per_tile, plan.seg).sum(1)
            head = rows[:: plan.seg]
            keep = head < n
            acc[head[keep]] = row_acc[keep]
            cnt[head[keep]] = row_cnt[keep]
    return new, acc.astype(np.uint32), cnt.astype(np.int32), visits


@pytest.mark.parametrize(
    "n,w,aligned,sm_count",
    [(1000, 16, True, 2), (1000, 16, False, 2), (1025, 4, True, 1), (100, 3, True, 1),
     (64, 40, True, 1), (1000, 1, True, 3), (40, 2048, True, 2), (33, 8, True, 132)],
)
def test_grid_model_equals_plain_and_xla(n, w, aligned, sm_count):
    arrays = _masks(n, w, seed=3 * n + w)
    plan = pex.exchange_plan(n, w, aligned, sm_count)
    new, acc, cnt, visits = _grid_model(*arrays, plan)
    assert (visits == 1).all()  # every word once, by one lane
    p_new, p_acc, p_cnt = pex.exchange_plain(*_port(arrays))
    assert np.array_equal(new, _np(p_new))
    assert np.array_equal(acc, _np(p_acc))
    assert np.array_equal(cnt, p_cnt.numpy())
    jn, ja, jc = jex.exchange(*[jnp.asarray(a) for a in arrays], impl="xla")
    assert np.array_equal(new, np.asarray(jn))
    assert np.array_equal(acc, np.asarray(ja))
    assert np.array_equal(cnt, np.asarray(jc))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,w",
    SHAPES + [(1000, 16), (1000, 40), (1000, 4), (1000, 8), (1025, 16), (1000, 512), (1000, 2048),
              (100_001, 16), (100_001, 8), (200_001, 4)],
)
def test_kernel_equals_plain_on_card(cuda_device, n, w):
    arrays = [u32.from_numpy(a, cuda_device) for a in _masks(n, w, seed=n + w)]
    for want_counts in (True, False):
        got = pex.exchange(*arrays, want_counts=want_counts)
        want = pex.exchange_plain(*arrays, want_counts=want_counts)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b), (n, w, want_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("offset_words,vec", [(1, 1), (16, 4)])
def test_kernel_on_a_view_equals_plain_on_card(cuda_device, offset_words, vec):
    """Planes that start ``offset_words`` words into their allocation: 4
    bytes in (off a 16-byte boundary: 4-byte lanes) or one row in (the
    ``heard[1:]`` of an [N + 1, W] tensor: 16-byte lanes, at an N whose
    4-word tiles fill the card)."""
    n, w = 100_001, 16
    arrays = [u32.from_numpy(a, cuda_device) for a in _masks(n, w, seed=9)]
    views = []
    for t in arrays[:3]:
        buf = torch.zeros(n * w + offset_words, dtype=torch.int32, device=cuda_device)
        views.append(buf[offset_words:].view(n, w))
        views[-1].copy_(t)
    assert pex.exchange_plan(n, w, pex._aligned(*views), pex._sm_count(cuda_device.index or 0)).vec == vec
    for want_counts in (True, False):
        got = pex.exchange(*views, arrays[3], want_counts=want_counts)
        want = pex.exchange_plain(*arrays, want_counts=want_counts)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b), (offset_words, want_counts)
