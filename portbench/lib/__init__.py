"""The harness's own code: lookup by name, traffic, timing, trace reduction."""
