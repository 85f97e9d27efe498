"""Benchmarks of the port that are not engine paths (the row-read probe)."""
