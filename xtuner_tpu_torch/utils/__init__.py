"""Config loading and logging of the port (counterpart: `xtuner_tpu/utils/`)."""
