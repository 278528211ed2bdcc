"""Data parallelism over the env batch (``mesh``), the counterpart of
``evomotion_tpu/parallel/``."""
