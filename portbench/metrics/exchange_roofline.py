"""`exchange`'s share of its roofline (``costs/exchange.py``), in percent."""

from portbench.lib.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "exchange")
