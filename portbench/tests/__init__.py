"""The benchmark's own tests: ``python -m pytest portbench/tests``."""
