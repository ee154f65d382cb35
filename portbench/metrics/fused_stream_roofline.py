"""`fused_stream`'s share of its roofline (``costs/fused_stream.py``), in percent."""

from portbench.lib.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "fused_stream")
