"""Simulated node-ticks a second: B x n x ticks completed / window seconds."""


def read(rec):
    return rec["node_ticks"] / rec["window_s"] if rec["ticks"] else None
