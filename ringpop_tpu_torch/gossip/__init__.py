"""Host-side SWIM gossip engine: protocol-period loop, piggyback
dissemination, suspicion subprotocol, and the ping / ping-req / join senders
over the framed JSON channel."""

from ringpop_tpu_torch.gossip.dissemination import Dissemination
from ringpop_tpu_torch.gossip.gossip import Gossip
from ringpop_tpu_torch.gossip.suspicion import Suspicion

__all__ = ["Dissemination", "Gossip", "Suspicion"]
