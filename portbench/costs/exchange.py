"""``csrc/exchange.cu``: ``new = heard | pulled | pushed`` over [B, N, W]
words and each row's sum of the rumor deltas of its new bits.

``ints``: ``(n, w, vec, seg, blocks, smem_table, b, delta_stride)``;
pointers: heard, pulled, pushed, r_delta, then new, acc, cnt.  The three
masks are read once and the new mask written; one delta table of 32 * W
words (per cluster unless ``delta_stride`` is 0); the per-row sum, and
the per-row count when asked for.  Operations: two ORs, an XOR, a
popcount and an add a word (a bit's delta add is data-dependent: left
out).
"""


def cost(ints, present):
    n, w, _vec, _seg, _blocks, _smem, b, delta_stride = ints
    words = b * n * w
    tables = b if delta_stride else 1
    nbytes = 4 * (4 * words + 32 * w * tables + b * n)
    if present[6]:
        nbytes += 4 * b * n
    return nbytes, 5 * words


def at(n: int, w: int, b: int = 1):
    return cost((n, w, 4, 1, 1, 0, b, 0), [True] * 6 + [False])
