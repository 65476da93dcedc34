"""Autotune: parity-gated probes (:mod:`.probes`) write calibration
records into a store (:mod:`.store`); the knob-resolution policy
(:mod:`.policy`) reads them for the API, the executor and the service;
``python -m consensus_clustering_tpu_torch autotune run|show|diff`` is
the command line (:mod:`.cli`)."""
