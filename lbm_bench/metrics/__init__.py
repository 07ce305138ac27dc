"""The per-layer metric readers, a file each named after the metric,
each with read(ctx) -> float or None."""
