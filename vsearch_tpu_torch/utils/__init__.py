"""Utilities: step timers, device memory and profiler traces."""
