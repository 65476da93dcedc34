"""Bounds of the roofline metrics: ``bounds/<span>.py`` names one kernel
launcher of the port (``MODULE``, ``ATTRIBUTE``) and holds
``bound_ms(config, *args, **kwargs)``, the least milliseconds a call's
work could take on the card (:mod:`portbench.spans`)."""
