"""Shared infrastructure (reference src/common/): perf counters and
launch spans for the device layer."""
