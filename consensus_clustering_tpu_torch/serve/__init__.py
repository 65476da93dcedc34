"""Serving (ROADMAP item A10): so far only the memory preflight that
``mode="auto"`` resolves against (:mod:`.preflight`)."""
