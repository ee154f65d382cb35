"""Host reads a tick of the scalable engine, by its own counter
(``engine_scalable.host_read.count``) over the traced window."""


def read(rec):
    reads = rec["counters"].get("host_read")
    return None if reads is None or not rec["ticks"] else reads / rec["ticks"]
