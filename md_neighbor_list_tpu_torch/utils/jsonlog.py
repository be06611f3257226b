"""Structured JSON-lines metrics logging (PyTorch port of
``md_neighbor_list_tpu/utils/jsonlog.py``): one JSON object per event, with
the JAX package's record fields (``ts``, ``run``, ``event``, then the
event's own)."""

from __future__ import annotations

import json
import sys
import time
from typing import IO


class JsonLogger:
    def __init__(self, stream: IO | None = None, run_id: str | None = None):
        self._stream = stream or sys.stderr
        self._run_id = run_id or f"run-{int(time.time())}"

    def log(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "run": self._run_id,
               "event": event}
        rec.update(fields)
        self._stream.write(json.dumps(rec) + "\n")
        self._stream.flush()
