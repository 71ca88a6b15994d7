"""Python-file config loading (counterpart: `xtuner_tpu/utils/config.py`).

A config is a plain ``.py`` file exec'd in an isolated namespace; its
top-level variables (``trainer``, model configs, ...) become attributes.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType
from typing import Any


class Config(dict):
    """A dict with attribute access holding the variables of an exec'd config file."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def fromfile(cls, filename: str | Path) -> "Config":
        filename = Path(filename).expanduser().resolve()
        if not filename.exists():
            raise FileNotFoundError(f"Config file not found: {filename}")
        if filename.suffix != ".py":
            raise ValueError(f"Only .py config files are supported, got: {filename}")
        spec = importlib.util.spec_from_file_location(f"_xtuner_cfg_{filename.stem}", filename)
        if spec is None or spec.loader is None:
            raise ValueError(f"Cannot load config file {filename}")
        module: ModuleType = importlib.util.module_from_spec(spec)
        # sibling imports inside the config's directory work
        sys.path.insert(0, str(filename.parent))
        try:
            spec.loader.exec_module(module)
        finally:
            sys.path.pop(0)
        cfg = cls()
        for key, value in vars(module).items():
            if key.startswith("__"):
                continue
            if isinstance(value, ModuleType):
                continue
            cfg[key] = value
        return cfg
