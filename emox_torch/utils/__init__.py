"""Utilities: the profiler capture and the step timer (profiling)."""
