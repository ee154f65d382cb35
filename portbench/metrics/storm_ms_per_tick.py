"""The storm's wall a tick: window seconds x 1000 / ticks completed."""


def read(rec):
    return rec["window_s"] * 1000.0 / rec["ticks"] if rec["ticks"] else None
