"""Public API of the port: the tick-cluster harness over the port's
engines, and the live node (the Ringpop facade, request proxy, sharding
handler, server endpoints, admin client and CLI)."""

from ringpop_tpu_torch.api.ringpop import Ringpop

__all__ = ["Ringpop"]
