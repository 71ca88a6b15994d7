"""The text data plane of the port (counterpart: `xtuner_tpu/datasets/`):
jsonl -> tokenize -> pack -> sample -> collate, in numpy."""
