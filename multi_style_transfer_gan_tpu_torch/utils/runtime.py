"""The JSONL metrics log of the training CLI (port of ``MetricsLogger``,
``utils/runtime.py:87``). The JAX file's compilation cache has no
counterpart: PyTorch runs eagerly."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """Append-only JSONL log, one object per ``log`` call with a ``t``
    timestamp; a no-op when ``path`` is None."""

    def __init__(self, path=None):
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, **record):
        if self._f is not None:
            record.setdefault("t", time.time())
            self._f.write(json.dumps(record) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
