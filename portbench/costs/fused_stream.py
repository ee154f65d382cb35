"""``csrc/fused_stream.cu``: FarmHash32 carries of B rows of N member records.

``ints``: ``(B, N, RW)``; pointers: h0, g0, f0, rec_words, rec_len,
total_blocks, then h, g, f.  Each row's RW-word records and lengths are
read once; the three carries in and out.  Operations: about ten a
record word appended (the mixing rounds, which depend on the lengths,
are left out of this lower bound).
"""


def cost(ints, present):
    b, n, rw = ints
    nbytes = 4 * b * (3 + n * rw + n + 1) + 4 * 3 * b
    return nbytes, 10 * b * n * (rw + 5)


def at(b: int, n: int, rw: int = 9):
    return cost((b, n, rw), [True] * 9)
