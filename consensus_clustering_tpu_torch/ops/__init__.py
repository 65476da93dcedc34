"""Tensor operations of the sweep: resampling, exact counts, analysis, and
the two hand-written CUDA kernels (:mod:`.hist`, :mod:`.lloyd`)."""
