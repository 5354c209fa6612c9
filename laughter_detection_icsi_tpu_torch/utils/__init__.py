"""Utilities: profiling, throughput counters and device timing."""
