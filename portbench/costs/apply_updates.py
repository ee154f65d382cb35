"""``csrc/apply_updates.cu``: one membership-update site over [B * R, N].

``ints``: ``(n, words, b, rows, lo)``; ``present``: the 33 pointers in the
entry point's order (state planes 0-9, update planes 10-14, union in 15,
now 16, deadline 17, state outputs 18-27, union out 28, applied 29, rows
30, count 31, refute 32).  Every state plane is read and written whole
(the site's result is a new state), every update plane read.
"""

STATE_BYTES = (1, 4, 4, 1, 4, 4, 4, 4, 4, 4)  # known .. susp_deadline, per cell
UPDATE_BYTES = (1, 4, 4, 4, 4)  # recv_mask, u_status, u_inc, u_source, u_source_inc
OPS_PER_CELL = 40  # the precedence table, refute, gate and ten selects


def cost(ints, present):
    n, words, b, rows, _lo = ints
    cells = b * rows * n
    nbytes = cells * (2 * sum(STATE_BYTES) + sum(UPDATE_BYTES))
    nbytes += 2 * 4 * b  # now, deadline
    if present[15]:
        nbytes += 4 * b * rows * words
    if present[28]:
        nbytes += 4 * b * rows * words
    if present[29]:
        nbytes += cells  # the dense applied mask
    nbytes += b * rows  # applied rows
    if present[31]:
        nbytes += 4 * b * rows
    if present[32]:
        nbytes += b * rows
    return nbytes, OPS_PER_CELL * cells


def at(n: int, b: int = 1, union: bool = True, masks: bool = True, count: bool = False,
       refute: bool = True):
    """The cost of one launch over ``b`` whole [n, n] clusters."""
    words = (n + 31) // 32
    present = [True] * 33
    present[15] = present[28] = union
    present[29], present[31], present[32] = masks, count, refute
    return cost((n, words, b, n, 0), present)
