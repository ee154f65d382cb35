"""Checksum-parity harness: host-object oracle run in lockstep with the
batched device engine, asserting bitwise-identical per-node membership
checksums every tick (the BASELINE.md north-star #1 contract)."""

from ringpop_tpu_torch.parity.oracle import OracleCluster, OracleTickResult

__all__ = ["OracleCluster", "OracleTickResult"]
