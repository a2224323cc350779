"""Runtime helpers: ``throughput_meter`` (port of ``utils/runtime.py:61``),
which prints items per second like the reference's batch report, and the
JSONL metrics log of the training CLI (``MetricsLogger``,
``utils/runtime.py:87``). The JAX file's compilation cache has no
counterpart: PyTorch runs eagerly."""

from __future__ import annotations

import json
import os
import time


class throughput_meter:
    """Context manager printing items/s and seconds per item, with an
    optional ``torch.profiler`` trace (CPU and CUDA activities) exported
    into ``trace_dir``. On a CUDA ``device`` it synchronizes at entry and
    at exit, so the time covers the work queued inside the block."""

    def __init__(self, n_items: int, label: str = "processed",
                 trace_dir: str | None = None, *, device=None):
        import torch

        self.n = n_items
        self.label = label
        self.trace_dir = trace_dir
        self.device = None if device is None else torch.device(device)
        self._prof = None

    def _sync(self):
        import torch

        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        if self.trace_dir:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.elapsed = time.perf_counter() - self.t0
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(
                self.trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
            self._prof = None
        per = self.elapsed / max(self.n, 1)
        print(f"{self.label}: {self.n} items in {self.elapsed:.2f}s "
              f"({self.n / max(self.elapsed, 1e-9):.2f}/s, {per:.3f}s each)")
        return False


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
