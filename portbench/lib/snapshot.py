"""A copy of an engine state in buffers allocated once.

The check after the window needs the program's state at a few moments of
it.  A :class:`Snapshot` allocates its buffers when it is made (in
set-up) and :meth:`take` copies into them, so the window allocates
nothing for it: the memory peak of the window less :attr:`nbytes` of
every snapshot is the program's own.
"""

from __future__ import annotations


class Snapshot:
    def __init__(self, state):
        self._type = type(state)
        self._bufs = tuple(None if x is None else x.clone() for x in state)
        self.nbytes = sum(0 if x is None else x.numel() * x.element_size() for x in self._bufs)

    def take(self, state) -> None:
        for buf, x in zip(self._bufs, state):
            if buf is not None:
                buf.copy_(x)

    @property
    def state(self):
        return self._type(*self._bufs)
