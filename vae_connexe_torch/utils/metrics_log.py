"""Structured metric logging (port of ``vae_connexe_tpu/utils/metrics_log.py``).

Trainers return metric dicts once a chunk; writers consume them on the
host.  ``JsonlWriter`` appends one JSON object per record.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Mapping


class JsonlWriter:
    def __init__(self, path: str):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("a")

    def write(self, step: int, metrics: Mapping[str, Any]) -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PrintWriter:
    """Console logging, one line a record."""

    def write(self, step: int, metrics: Mapping[str, Any]) -> None:
        parts = " ".join(f"{k}={float(v):.5f}" for k, v in metrics.items()
                         if isinstance(v, (int, float)) or hasattr(v, "item"))
        print(f"[step {step}] {parts}")

    def close(self) -> None:
        pass
