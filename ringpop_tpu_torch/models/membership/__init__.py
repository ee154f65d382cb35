from ringpop_tpu_torch.models.membership.host import (
    Member,
    Membership,
    MembershipIterator,
    Status,
    Update,
    LeaveUpdate,
    merge_membership_changesets,
)

__all__ = [
    "Member",
    "Membership",
    "MembershipIterator",
    "Status",
    "Update",
    "LeaveUpdate",
    "merge_membership_changesets",
]
