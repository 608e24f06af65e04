"""Structured metrics logging.

Port of ``mvxnet_makise_tpu/utils/logging.py`` (a copy: the port imports
nothing of the JAX package).  An append-only JSONL writer, one record per
logging event, plus a console mirror; the records and the console line
are the JAX package's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics log with console mirroring."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any], **extra):
        """Write one record: ``step``, seconds since the logger was made
        (``time``), then every metric and extra field, as a float where
        ``float()`` takes it (tensors of one element included)."""
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in {**metrics, **extra}.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if self.echo:
            body = " ".join(
                f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("time",))
            print(body)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
