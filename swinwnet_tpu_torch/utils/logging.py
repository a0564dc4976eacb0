"""Structured metrics logging (port of `swinwnet_tpu/utils/logging.py`):
JSONL records {step, wall_time, **metrics}, one per call."""

from __future__ import annotations

import json
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        if self._f is None:
            return
        rec = {"step": step, "wall_time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
