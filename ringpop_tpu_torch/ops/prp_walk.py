"""The scalable engine's partner permutation: a keyed 4-round Feistel
bijection over ``[0, 4^hb)``, cycle-walked back into ``[0, n)``.

Counterpart of the PRP of ``ringpop_tpu/models/sim/engine_scalable.py``
(``_prp_f``, ``_prp_apply``, ``_prp_perm``: a ``while_loop`` that applies
the bijection to every value still out of range).  :func:`prp_walk`
launches ``csrc/prp_walk.cu`` on CUDA tensors, each value walked in its own
thread, one launch and no host read; on CPU tensors it runs
:func:`prp_walk_plain`, whose every step reads on the host whether any
value is still out of range.  Both give the same values: a value's walk
does not depend on the others'.

uint32 values are int32 bit patterns (:mod:`ringpop_tpu_torch.ops.u32`).
"""

from __future__ import annotations

import torch

from ringpop_tpu_torch.ops import _build, toolkit, u32

ROUNDS = 4


def feistel_f(r: torch.Tensor, k: torch.Tensor, mask: int) -> torch.Tensor:
    """Feistel round function truncated to the half-width."""
    x = r * u32.s32(0x7FEB352D) + k
    x = x ^ u32.srl(x, 15)
    x = x * u32.s32(0x846CA68B)
    x = x ^ u32.srl(x, 13)
    return x & mask


def half_bits(n: int) -> int:
    """Half-width of the Feistel domain: smallest hb with 4^hb >= n."""
    return max(1, (max(n - 1, 1).bit_length() + 1) // 2)


def feistel(v: torch.Tensor, keys: torch.Tensor, hb: int, inverse: bool = False) -> torch.Tensor:
    """One PRP pass over [0, 4^hb); ``inverse`` runs the rounds backwards.
    ``keys``: [ROUNDS], or [B, ROUNDS] with ``v`` [B, N] (one key set a row)."""
    mask = (1 << hb) - 1
    left = u32.srl(v, hb)
    right = v & mask
    if not inverse:
        for r in range(ROUNDS):
            left, right = right, left ^ feistel_f(right, keys[..., r, None], mask)
    else:
        for r in reversed(range(ROUNDS)):
            left, right = right ^ feistel_f(left, keys[..., r, None], mask), left
    return (left << hb) | right


def prp_walk_plain(  # torchgate: host
    ids: torch.Tensor, keys: torch.Tensor, n: int, inverse: bool
) -> torch.Tensor:
    """Plain PyTorch version of :func:`prp_walk`: every step applies the
    bijection to the values still out of range, one host read a step (the
    engine's own walk yields that read to its shard loop instead)."""
    hb = half_bits(n)
    x = feistel(ids, keys, hb, inverse)
    while True:
        out = u32.uge(x, n)
        if not bool(out.any()):
            return x
        x = torch.where(out, feistel(x, keys, hb, inverse), x)


def prp_walk(ids: torch.Tensor, keys: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    """The bijection over [0, n) at ``ids`` ([M] int32, each in [0, n)):
    [M] for a [ROUNDS] key set, [B, M] for B key sets ``[B, ROUNDS]``.
    A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`prp_walk_plain`.  Inside ``torch.func.vmap`` (batched keys) the
    custom op ``ringpop_torch::prp_walk`` walks the B rows in one launch."""
    if toolkit.is_batched(ids, keys):
        return _walk_op(ids, keys, n, inverse)
    return _rows(ids, keys, n, inverse)


def _rows(ids: torch.Tensor, keys: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    if ids.device.type == "cpu":
        return prp_walk_plain(ids, keys, n, inverse)
    return _launch(ids, keys, n, inverse)


def _launch(ids: torch.Tensor, keys: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    dev = ids.device
    hb = half_bits(n)
    if ids.dim() != 1 or keys.shape[-1] != ROUNDS or keys.dim() > 2:
        raise ValueError("prp_walk: ids [M] and keys [%d] or [B, %d], got %s and %s"
                         % (ROUNDS, ROUNDS, tuple(ids.shape), tuple(keys.shape)))
    lead = tuple(keys.shape[:-1])
    rows = keys.reshape(-1, ROUNDS).shape[0]
    ids = ids.to(torch.int32).contiguous()
    keys = keys.to(torch.int32).reshape(rows, ROUNDS).contiguous()
    _build.check("prp_walk", dev, [("ids", ids, torch.int32, ids.shape),
                                   ("keys", keys, torch.int32, (rows, ROUNDS))])
    out = torch.empty(lead + tuple(ids.shape), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    _build.library().call("ringpop_prp_walk", dev, [_build.ptr(t) for t in (ids, keys, out)],
                          rows, ids.shape[0], n, hb, int(inverse))
    prp_walk.launches += 1
    return out


prp_walk.launches = 0


# ---------------------------------------------------------------------------
# the batch axis: B key sets in one launch


@torch.library.custom_op(toolkit.LIB + "::prp_walk", mutates_args=())
def _walk_op(ids: torch.Tensor, keys: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    """One key set through the op (the wrapper calls it only inside vmap,
    where the rule below runs instead)."""
    return _rows(ids, keys, n, inverse)


def _walk_rule(info, in_dims, ids, keys, n, inverse):
    if in_dims[0] is not None:
        raise ValueError("prp_walk: the ids are one for every key set")
    return _rows(ids, toolkit.batch_front(keys, in_dims[1], info.batch_size), n, inverse), 0


torch.library.register_vmap(toolkit.LIB + "::prp_walk", _walk_rule)
