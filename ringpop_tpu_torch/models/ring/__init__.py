"""Consistent hash ring of the port: the host ring of a live node
(``host.HashRing``) and the device ring of the simulators (``device``)."""

from ringpop_tpu_torch.models.ring.host import HashRing

__all__ = ["HashRing"]
