"""Per-layer metric readers: `metrics/<name>.py` defines
`read(rec) -> float | None` over the traced run's records (harness.py,
`_records`); None leaves the metric out of the result line."""
