"""The port's batch program, folder pipeline, server and CLIs (CPU), and
the rule that the port never imports JAX."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from multi_style_transfer_gan_tpu.data.synthetic import render_photo
from multi_style_transfer_gan_tpu.pipelines.batch import (
    make_batch_fn as jax_make_batch_fn,
)
from multi_style_transfer_gan_tpu.pipelines.model_loader import (
    load_generator as jax_load_generator,
)
from multi_style_transfer_gan_tpu_torch.pipelines import (
    batch_process, load_generator, make_batch_fn,
)
from multi_style_transfer_gan_tpu_torch.serving import (
    MicroBatcher, StyleTransferService, serve,
)

TRAINED = "trained/G_BA_selected.pth"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    return load_generator(TRAINED, device="cpu")


@pytest.mark.parametrize("mode,local_style_mode", [("cyclegan", "enhanced"),
                                                   ("local_style", "simple")])
def test_batch_fn_matches_jax_uint8(model, mode, local_style_mode):
    """uint8 -> uint8 on the same trained weights: at most 1 LSB apart."""
    batch = np.stack([render_photo(900100 + i, size=64) for i in range(2)])
    batch = batch.astype(np.uint8)
    ref = np.asarray(jax_make_batch_fn(
        jax_load_generator(TRAINED), mode, local_style_mode, 0.8, 0.7, True,
        True)(batch))
    got = make_batch_fn(model, mode, local_style_mode, 0.8, device="cpu")(batch)
    assert got.dtype == torch.uint8 and got.shape == batch.shape
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("kwargs,match", [
    (dict(mode="local_style", local_style_mode="enhanced"), "post chain"),
    (dict(mode="local_style", local_style_mode="advanced"), "post chain"),
    (dict(engine="int8"), "not ported"),
])
def test_batch_fn_raises_for_what_is_not_ported(model, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        make_batch_fn(model, device="cpu", **kwargs)


def _write_images(folder, sizes, seed=0):
    rng = np.random.default_rng(seed)
    names = []
    for i, (w, h) in enumerate(sizes):
        ext = ("jpg", "png", "bmp")[i % 3]
        name = f"img{i}.{ext}"
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            folder / name)
        names.append(name)
    return names


def test_batch_process_writes_every_image_at_its_size(model, tmp_path):
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    sizes = [(80, 50), (40, 72), (64, 64)]
    names = _write_images(src, sizes)
    stats = batch_process(model, src, out, batch_size=4, canvas=64,
                          decode_workers=2, device="cpu")
    assert stats["processed"] == 3
    for name, size in zip(names, sizes):
        with Image.open(out / "cyclegan_photo2monet" / name) as img:
            assert img.size == size


def _png_bytes(w, h, seed=0):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def test_server_round_trip(model):
    service = StyleTransferService(model, canvas=64, max_batch=2,
                                   max_wait_ms=5.0, device="cpu")
    server = serve(service, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address
    try:
        outs = [None] * 3

        def post(i):
            req = urllib.request.Request(f"http://{host}:{port}/stylize",
                                         data=_png_bytes(50, 40, seed=i),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                outs[i] = (r.status, r.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for status, body in outs:
            assert status == 200
            assert Image.open(io.BytesIO(body)).size == (50, 40)
        with urllib.request.urlopen(f"http://{host}:{port}/stats",
                                    timeout=10) as r:
            assert json.loads(r.read())["requests"] == 3
        bad = urllib.request.Request(f"http://{host}:{port}/stylize",
                                     data=b"not an image", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=10)
        assert ei.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        service.close()


def test_microbatcher_hands_each_request_its_slice():
    seen = []

    def run_fn(batch):
        seen.append(batch.shape)
        return torch.from_numpy(batch) + 1

    b = MicroBatcher(run_fn, canvas=8, max_batch=4, max_wait_ms=50.0)
    try:
        results = [None] * 6

        def post(i):
            results[i] = b.submit(np.full((8, 8, 3), i, np.uint8))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        for i in range(6):
            np.testing.assert_array_equal(results[i],
                                          np.full((8, 8, 3), i + 1, np.uint8))
        assert set(seen) == {(4, 8, 8, 3)} and b.images == 6
    finally:
        b.close()


def test_microbatcher_stress_keeps_every_result_and_count():
    """32 concurrent requesters (more than cores) with a short switch
    interval: each gets its own slice back and no counter loses an update."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    b = MicroBatcher(lambda batch: torch.from_numpy(batch) + 1, canvas=4,
                     max_batch=4, max_wait_ms=1.0, max_queue=64)
    try:
        results = {}

        def post(i):
            results[i] = b.submit(np.full((4, 4, 3), i, np.uint8), timeout=30)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        for i in range(32):
            np.testing.assert_array_equal(results[i],
                                          np.full((4, 4, 3), i + 1, np.uint8))
        assert b.requests == 32 and b.images == 32 and b.shed == 0
    finally:
        sys.setswitchinterval(switch)
        b.close()


def test_microbatcher_propagates_errors():
    def run_fn(batch):
        raise RuntimeError("kaboom")

    b = MicroBatcher(run_fn, canvas=8, max_batch=2, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="kaboom"):
            b.submit(np.zeros((8, 8, 3), np.uint8))
    finally:
        b.close()


@pytest.mark.parametrize("cli,argv", [
    ("batch_process_images", ["--input_dir", "nowhere"]),
    ("serve", ["--model", TRAINED]),
])
def test_clis_exit_nonzero_without_cuda(monkeypatch, capsys, cli, argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(
        f"multi_style_transfer_gan_tpu_torch.cli.{cli}").main
    assert main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_batch_cli_data_parallel_is_not_ported(capsys):
    from multi_style_transfer_gan_tpu_torch.cli.batch_process_images import main

    assert main(["--data_parallel"]) != 0
    assert "not ported" in capsys.readouterr().err


def test_port_never_imports_jax():
    """Importing the port and every submodule leaves jax out of
    sys.modules (a fresh interpreter, since the tests themselves use JAX)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multi_style_transfer_gan_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith(pkg.__name__)]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
