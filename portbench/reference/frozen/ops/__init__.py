"""Frozen copy (see portbench/reference/frozen/__init__.py)."""
