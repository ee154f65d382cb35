"""Consistent hash ring of the port."""
