"""The fused FarmHash32 record stream: plain version and CUDA kernel.

Counterpart of ``ringpop_tpu/ops/pallas_farmhash.py`` lines 163-426: the
shape-agnostic :func:`stream_member_step`, its member-axis loop
:func:`fused_stream_plain` (the twin of ``fused_stream_xla``) and the
kernel wrapper :func:`fused_stream`, which launches
``csrc/fused_stream.cu`` on a CUDA tensor and runs the plain version on a
CPU tensor.

The stream state per row is tiny: the three mixing carries, a <RES_W-word
residual of not-yet-consumed bytes, the residual byte count and the count
of 20-byte blocks already mixed.  Appending a member's record is a variable
byte shift (word shift in [0, 4] plus a bit shift); consuming a block is a
5-word shift-down.  Invariant: residual bytes at or beyond ``res_len`` are
zero (records are zero-padded past their length), so append is a plain OR.
"""

from __future__ import annotations

from typing import List

import torch

from ringpop_tpu_torch.ops import _build, toolkit
from ringpop_tpu_torch.ops.farmhash import C1, _mur
from ringpop_tpu_torch.ops.u32 import srl_var


def stream_geometry(rec_words: int):
    """(RES_W, ROUNDS) for a record capacity of ``rec_words`` words:
    residual capacity covers 19 carried bytes + one full record; ROUNDS is
    the most 20-byte blocks one append can complete."""
    cap = 19 + 4 * rec_words
    return (cap + 3) // 4, cap // 20


def stream_member_step(carry, rec, rec_len):
    """Append ONE member record to each row's residual and consume every
    completed 20-byte block (bit-exact farmhashmk mixing order).

    ``carry``: (h, g, f, res tuple[RES_W], res_len, done, total_blocks),
    all int32 tensors of one row shape; ``rec``: tuple[RW] of record words
    (zero-padded past ``rec_len``); ``rec_len``: record byte length (0 for
    an absent member)."""
    h, g, f, res, res_len, done, total_blocks = carry
    res_w = len(res)
    rw = len(rec)
    rounds = stream_geometry(rw)[1]
    zero = torch.zeros_like(rec[0])

    # -- append: shift the record up by res_len bytes and OR it in --------
    appending = done < total_blocks
    q = res_len
    wq = q >> 2  # word shift, in [0, 4] (res_len <= 19 while appending)
    bq = (q & 3) << 3  # bit shift within the word
    back = (32 - bq) & 31  # keeps the shift defined at bq == 0

    def rec_ext(k):
        return rec[k] if 0 <= k < rw else zero

    new_res = []
    for w in range(res_w):
        cand = zero
        prev = zero
        for k in range(min(w, 4) + 1):
            sel = wq == k
            cand = torch.where(sel, rec_ext(w - k), cand)
            prev = torch.where(sel, rec_ext(w - k - 1), prev)
        spill = srl_var(prev, back)
        shifted = torch.where(bq == 0, cand, (cand << bq) | spill)
        new_res.append(res[w] | torch.where(appending, shifted, zero))
    res = new_res
    res_len = res_len + torch.where(appending, rec_len, 0)

    # -- consume completed blocks (at most ``rounds`` per append) ---------
    for _ in range(rounds):
        can = (res_len >= 20) & (done < total_blocks)
        a, b, c, d, e = res[0], res[1], res[2], res[3], res[4]
        nh = h + a
        ng = g + b
        nf = f + c
        nh = _mur(d, nh) + e
        ng = _mur(c, ng) + a
        nf = _mur(b + e * C1, nf) + d
        nf = nf + ng
        ng = ng + nf
        h = torch.where(can, nh, h)
        g = torch.where(can, ng, g)
        f = torch.where(can, nf, f)
        res = [
            torch.where(can, res[w + 5] if w + 5 < res_w else zero, res[w])
            for w in range(res_w)
        ]
        res_len = res_len - can.to(torch.int32) * 20
        done = done + can.to(torch.int32)
    return (h, g, f, tuple(res), res_len, done, total_blocks)


def fused_stream_plain(h0, g0, f0, rec_words, rec_len, total_blocks):
    """Plain PyTorch version of :func:`fused_stream`: ``stream_member_step``
    looped over the member axis with [B]-vector rows."""
    B, N, RW = rec_words.shape
    res_w, _ = stream_geometry(RW)
    tb = total_blocks.to(torch.int32)
    res0 = tuple(torch.zeros(B, dtype=torch.int32, device=h0.device) for _ in range(res_w))
    izero = torch.zeros(B, dtype=torch.int32, device=h0.device)
    carry = (h0, g0, f0, res0, izero, izero, tb)
    for m in range(N):
        carry = stream_member_step(
            carry, tuple(rec_words[:, m, w] for w in range(RW)), rec_len[:, m]
        )
    h, g, f = carry[:3]
    return h, g, f


def fused_stream(h0, g0, f0, rec_words, rec_len, total_blocks):
    """The (h, g, f) carries after streaming every member record through
    the farmhashmk 20-byte mixing loop.

    ``h0/g0/f0``: [B] int32 (uint32) carries after the tail mixes;
    ``rec_words``: [B, N, RW] int32 record words, zero-padded;
    ``rec_len``: [B, N] int32 record byte lengths (0 = absent);
    ``total_blocks``: [B] int32 blocks to mix ((len-1)//20 for long rows,
    0 otherwise).  A CUDA tensor launches ``csrc/fused_stream.cu``; a CPU
    tensor runs :func:`fused_stream_plain`.  Inside ``torch.func.vmap``
    the call goes through the custom op ``ringpop_torch::fused_stream``,
    whose batching rule hashes the rows of every cluster in one launch."""
    args = (h0, g0, f0, rec_words, rec_len, total_blocks)
    if toolkit.is_batched(*args):
        return tuple(_stream_op(*args))
    if rec_words.device.type == "cpu":
        return fused_stream_plain(*args)
    return _launch(*args)


def _launch(h0, g0, f0, rec_words, rec_len, total_blocks):
    B, N, RW = rec_words.shape
    dev = rec_words.device
    i32 = torch.int32
    _build.check("fused_stream", dev, (
        ("h0", h0, i32, (B,)), ("g0", g0, i32, (B,)), ("f0", f0, i32, (B,)),
        ("rec_words", rec_words, i32, (B, N, RW)), ("rec_len", rec_len, i32, (B, N)),
        ("total_blocks", total_blocks, i32, (B,)),
    ))
    h = torch.empty_like(h0)
    g = torch.empty_like(g0)
    f = torch.empty_like(f0)
    ptrs = [_build.ptr(t) for t in (h0, g0, f0, rec_words, rec_len, total_blocks, h, g, f)]
    _build.library().call("ringpop_fused_stream", ptrs, B, N, RW)
    fused_stream.launches += 1
    return h, g, f


fused_stream.launches = 0


# ---------------------------------------------------------------------------
# the batch axis: the rows of B clusters in one launch


def _clusters(args):
    """C clusters' ``[C, R, ...]`` operands hashed as one ``[C * R, ...]``
    row set (the kernel's rows are independent)."""
    h0 = args[0]
    flat = tuple(t.reshape((-1,) + tuple(t.shape[2:])).contiguous() for t in args)
    if h0.device.type == "cpu":
        out = fused_stream_plain(*flat)
    else:
        out = _launch(*flat)
    return [t.reshape(h0.shape) for t in out]


@torch.library.custom_op(toolkit.LIB + "::fused_stream", mutates_args=())
def _stream_op(
    h0: torch.Tensor, g0: torch.Tensor, f0: torch.Tensor, rec_words: torch.Tensor,
    rec_len: torch.Tensor, total_blocks: torch.Tensor,
) -> List[torch.Tensor]:
    """One cluster's rows through the op (the wrapper calls it only inside
    vmap, where the rule below runs instead)."""
    args = (h0, g0, f0, rec_words, rec_len, total_blocks)
    return [t[0] for t in _clusters(tuple(t[None] for t in args))]


def _stream_rule(info, in_dims, *args):
    b = info.batch_size
    out = _clusters(tuple(toolkit.batch_front(t, d, b) for t, d in zip(args, in_dims)))
    return out, [0, 0, 0]


torch.library.register_vmap(toolkit.LIB + "::fused_stream", _stream_rule)
