"""Throughput metering and profiler traces."""
