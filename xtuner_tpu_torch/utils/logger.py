"""Rank-tagged logging (counterpart: `xtuner_tpu/utils/logger.py`).

One process-wide stdlib logger whose records carry the process rank
(`XTUNER_RANK`), with the JAX package's line format; `log_file_handler`
mirrors it to a file and returns the handler so its owner can close it.
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER: logging.Logger | None = None

_FORMAT = "[XTuner][RANK %(rank)s][%(asctime)s][%(levelname)s] %(message)s"


class _RankFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        if not hasattr(record, "rank"):
            record.rank = os.environ.get("XTUNER_RANK", "0")
        return True


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("xtuner_tpu_torch")
        logger.propagate = False
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
        handler.addFilter(_RankFilter())
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("XTUNER_LOG_LEVEL", "INFO"))
        _LOGGER = logger
    return _LOGGER


def log_file_handler(path: str) -> logging.Handler:
    """Additionally mirror logs to ``path`` (one file per rank,
    ``rank{N}.log``). Remove and close the returned handler when done."""
    logger = get_logger()
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
    handler.addFilter(_RankFilter())
    logger.addHandler(handler)
    return handler
