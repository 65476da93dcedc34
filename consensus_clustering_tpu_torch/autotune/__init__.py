"""Autotune, the read side: the knob-resolution policy and the
calibration store it reads (:mod:`.policy`, :mod:`.store`).  The probes
and the calibration CLI are ROADMAP A12."""
