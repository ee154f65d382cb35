"""Admin client (client.js rebuilt): drive any node's admin endpoints over
the channel — config get/set, gossip start/stop/tick, lookup, stats,
member join/leave (client.js:37-95)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ringpop_tpu_torch.net.channel import Channel


class RingpopClient:
    def __init__(self, channel: Optional[Channel] = None, timeout_s: float = 5.0):
        self._owns_channel = channel is None
        self.channel = channel or Channel()
        self.timeout_s = timeout_s

    def _call(self, host_port: str, endpoint: str, body: Any = None):
        _, res = self.channel.request(
            host_port, endpoint, head=None, body=body, timeout_s=self.timeout_s
        )
        return res

    # -- admin surface (client.js:37-95) ----------------------------------

    def admin_config_get(self, host_port: str) -> Dict[str, Any]:
        return self._call(host_port, "/admin/config/get")

    def admin_config_set(self, host_port: str, config: Dict[str, Any]):
        return self._call(host_port, "/admin/config/set", config)

    def admin_gossip_start(self, host_port: str):
        return self._call(host_port, "/admin/gossip/start")

    def admin_gossip_stop(self, host_port: str):
        return self._call(host_port, "/admin/gossip/stop")

    def admin_gossip_tick(self, host_port: str):
        return self._call(host_port, "/admin/gossip/tick")

    def admin_gossip_status(self, host_port: str):
        return self._call(host_port, "/admin/gossip/status")

    def admin_stats(self, host_port: str):
        return self._call(host_port, "/admin/stats")

    def admin_lookup(self, host_port: str, key: str):
        return self._call(host_port, "/admin/lookup", {"key": key})

    def admin_member_join(self, host_port: str):
        return self._call(host_port, "/admin/member/join")

    def admin_member_leave(self, host_port: str):
        return self._call(host_port, "/admin/member/leave")

    def health(self, host_port: str):
        return self._call(host_port, "/health")

    def destroy(self) -> None:
        if self._owns_channel:
            self.channel.destroy()
