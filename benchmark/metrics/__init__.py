"""Per-layer metrics, one module each, named after the metric with dots as
underscores. Each has `NAME`, `UNIT` and `read(observation)`, which
returns the value, or None where the run gives it nothing to read: the
harness then leaves the metric out of the result."""
