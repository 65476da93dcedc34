"""The benchmark's tests: ``python -m pytest portbench/tests`` (the
``cuda``-marked ones skip without a card)."""
