"""Parallelism layout of the port (counterpart: `xtuner_tpu/parallel/`)."""
