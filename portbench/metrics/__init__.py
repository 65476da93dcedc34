"""Readers of the per-layer metrics: ``metrics/<name>.py`` holds
``read(record)``, which returns the metric, or None where the traced run
holds nothing to read."""
