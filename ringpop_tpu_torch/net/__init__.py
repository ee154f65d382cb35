"""Host-side networking of the port: the framed JSON-over-TCP channel of a
live node (the role TChannel plays for the reference; the JAX package's
wire format byte for byte) and the timer service behind gossip,
suspicion, proxy retries and the trace host."""

from ringpop_tpu_torch.net.channel import Channel, ChannelError, RemoteError
from ringpop_tpu_torch.net.timers import FakeTimers, Timers

__all__ = ["Channel", "ChannelError", "RemoteError", "Timers", "FakeTimers"]
