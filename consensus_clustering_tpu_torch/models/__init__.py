"""Inner clusterers run on every resample of the sweep."""
