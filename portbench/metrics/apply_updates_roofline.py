"""`apply_updates`'s share of its roofline (``costs/apply_updates.py``), in percent."""

from portbench.lib.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "apply_updates")
