"""Host ms a tick inside the ping-req fanout: the host ns of every
``ping_req`` span of the program's span log (``ping_req_ns``) over the
traced window / 1e6 / ticks."""


def read(rec):
    ns = rec["counters"].get("ping_req_ns")
    return None if ns is None or not rec["ticks"] else ns / 1e6 / rec["ticks"]
