"""Run metrics."""
