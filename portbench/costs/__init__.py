"""Bytes and operations one launch of a port kernel needs, from its shapes.

Each module's ``cost(ints, present)`` takes a launch's integer arguments
(as the C entry point gets them) and which of its pointers were passed,
and returns ``(bytes, operations)``: each input byte read once and each
output byte written once, for the work these inputs need.  Operations are
a lower bound (the data-dependent part is left out); at these shapes the
bytes bound every kernel.
"""
