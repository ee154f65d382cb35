"""Gated phases of the scalable tick that ran, a tick: the program's
counter ``gate.open`` over the traced window / ticks."""


def read(rec):
    opened = rec["counters"].get("gate.open")
    return None if opened is None or not rec["ticks"] else opened / rec["ticks"]
