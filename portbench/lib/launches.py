"""The port's kernel launches in a traced window, with their arguments.

Every kernel of the port is launched through one call,
``ringpop_tpu_torch.ops._build.KernelLibrary.call(name, device, ptrs,
*ints)``.  While a :class:`LaunchLog` is open it records, for each launch,
the entry point, its integer arguments (the shapes) and which pointers
were passed (an absent optional operand is a null pointer).  The cost
functions in ``costs/`` turn those into bytes and operations.
"""

from __future__ import annotations

from collections import defaultdict


class LaunchLog:
    def __init__(self):
        self.calls = defaultdict(list)

    def __enter__(self):
        from ringpop_tpu_torch.ops import _build

        self._cls, self._orig = _build.KernelLibrary, _build.KernelLibrary.call
        orig, calls = self._orig, self.calls

        def call(lib, name, device, ptrs, *ints):
            calls[name].append((tuple(int(i) for i in ints), tuple(bool(p) for p in ptrs)))
            return orig(lib, name, device, ptrs, *ints)

        self._cls.call = call
        return self

    def __exit__(self, *exc):
        self._cls.call = self._orig
        return False
