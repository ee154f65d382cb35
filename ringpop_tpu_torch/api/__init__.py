"""Operator-facing entry points of the port (the tick-cluster harness)."""
