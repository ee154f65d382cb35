"""Join-response aggregation (lib/gossip/join-response-merge.js rebuilt).

If every join response carries the same membership checksum, the first
response's membership is taken verbatim; otherwise the changesets merge,
keeping the highest incarnation per address (join-response-merge.js:24-56).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ringpop_tpu_torch.models.membership.host import (
    Update,
    merge_membership_changesets,
)


def merge_join_responses(
    ringpop: Any, responses: List[Dict[str, Any]]
) -> List[Update]:
    if not responses:
        return []
    checksums = {r.get("checksum") for r in responses}
    if len(checksums) == 1 and None not in checksums:
        members = responses[0].get("members") or []
        return [Update.from_dict(m) for m in members]
    changesets = [
        [Update.from_dict(m) for m in (r.get("members") or [])]
        for r in responses
    ]
    return merge_membership_changesets(ringpop, changesets)
