"""``utils.throughput_meter`` of the port against the JAX package's on the
CPU: the same printed line for the same items, label and clock, a
``torch.profiler`` trace written into ``trace_dir``, no error for zero
items, and the CUDA synchronizations around the block."""

import os
import time

import pytest
import torch

from multi_style_transfer_gan_tpu.utils import runtime as jax_runtime
from multi_style_transfer_gan_tpu_torch.utils import throughput_meter


def _clock(monkeypatch, *ticks):
    """time.perf_counter returns ``ticks`` in turn (both modules read the
    same ``time``)."""
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def _line(meter_cls, monkeypatch, capsys, n, label, ticks, **kw):
    _clock(monkeypatch, *ticks)
    with meter_cls(n, label, **kw) as m:
        pass
    out = capsys.readouterr().out
    return out, m.elapsed


@pytest.mark.parametrize("n, label, ticks", [
    (16, "processed", (10.0, 12.5)),
    (3, "stylized", (0.25, 0.2501)),
    (1000, "images", (100.0, 100.0)),
])
def test_throughput_meter_prints_the_jax_line(n, label, ticks, monkeypatch,
                                              capsys):
    port = _line(throughput_meter, monkeypatch, capsys, n, label, ticks,
                 device="cpu")
    want = _line(jax_runtime.throughput_meter, monkeypatch, capsys, n, label,
                 ticks)
    assert port == want
    assert port[0].startswith(f"{label}: {n} items in ")


def test_throughput_meter_zero_items(monkeypatch, capsys):
    port = _line(throughput_meter, monkeypatch, capsys, 0, "processed",
                 (1.0, 1.5))
    assert port == _line(jax_runtime.throughput_meter, monkeypatch, capsys, 0,
                         "processed", (1.0, 1.5))
    assert port[0] == "processed: 0 items in 0.50s (0.00/s, 0.500s each)\n"


def test_throughput_meter_writes_a_trace_on_the_cpu(tmp_path, capsys):
    trace_dir = str(tmp_path / "trace")
    with throughput_meter(4, "traced", trace_dir=trace_dir, device="cpu"):
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(os.path.join(trace_dir, files[0])) > 0
    assert capsys.readouterr().out.startswith("traced: 4 items in ")


def test_throughput_meter_synchronizes_a_cuda_device(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    _clock(monkeypatch, 2.0, 3.0)
    with throughput_meter(2, device="cuda:0"):
        assert len(calls) == 1
    assert calls == [torch.device("cuda:0")] * 2
    _clock(monkeypatch, 2.0, 3.0)
    with throughput_meter(2, device="cpu"):
        pass
    assert len(calls) == 2
    capsys.readouterr()
