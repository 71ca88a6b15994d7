"""Experiment trackers of the port (counterpart: `xtuner_tpu/writer/`)."""

from .jsonl_writer import JsonlWriter, TensorboardWriter

__all__ = ["JsonlWriter", "TensorboardWriter"]
