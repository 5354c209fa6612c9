"""Utilities: profiling and throughput counters."""
