"""Train checkpoints of the port (counterpart: `xtuner_tpu/checkpoint/`)."""
