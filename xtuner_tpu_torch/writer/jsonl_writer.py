"""JSONL experiment tracker (counterpart:
`xtuner_tpu/writer/jsonl_writer.py`): one JSON record per logged step in
`<log_dir>/tracker.jsonl`, written by a background thread.
`TensorboardWriter` (`writer/tb_writer.py`) raises."""

from __future__ import annotations

import json
import queue
import threading
from pathlib import Path
from typing import Any

from .. import not_ported


class JsonlWriter:
    def __init__(self, log_dir: str | Path):
        self.path = Path(log_dir) / "tracker.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._queue: queue.Queue = queue.Queue()
        self._file = open(self.path, "a")
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._queue.get()
            if item is None:
                break
            self._file.write(json.dumps(item) + "\n")
            self._file.flush()

    def add_scalars(self, scalars: dict[str, Any], step: int) -> None:
        record = {"step": step}
        record.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in scalars.items()})
        self._queue.put(record)

    def close(self) -> None:
        """Write every queued record, then close the file."""
        self._queue.put(None)
        self._thread.join()
        self._file.close()


class TensorboardWriter:
    def __init__(self, log_dir: str | Path):
        raise not_ported("the tensorboard tracker (exp_tracker='tensorboard')", "trainer-rest")
