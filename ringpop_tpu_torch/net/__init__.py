"""Host-side timer service of the port (the JAX package's ``net/`` also
holds the live node's channel, which the port has no use for)."""

from ringpop_tpu_torch.net.timers import FakeTimers, Timers

__all__ = ["Timers", "FakeTimers"]
