"""The SFT trainer and CLI of the port (counterpart: `xtuner_tpu/train/`)."""
