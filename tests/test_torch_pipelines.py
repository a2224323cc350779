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


# the post chains threshold masks and round at the end: more than 1 level
# apart on at most 0.1% of values, mean |d| at most 0.05 levels
LEVEL_SHARE, MEAN_LEVELS = 1e-3, 0.05


def _assert_levels(ref, got):
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    assert (d > 1).mean() <= LEVEL_SHARE and d.mean() <= MEAN_LEVELS


@pytest.mark.parametrize("mode,local_style_mode", [("cyclegan", "enhanced"),
                                                   ("local_style", "simple"),
                                                   ("local_style", "enhanced"),
                                                   ("local_style", "advanced")])
def test_batch_fn_matches_jax_uint8(model, mode, local_style_mode):
    """uint8 -> uint8 on the same trained weights: at most 1 LSB apart, and
    within the post chains' limits where a chain runs."""
    batch = np.stack([render_photo(900100 + i, size=64) for i in range(2)])
    batch = batch.astype(np.uint8)
    ref = np.asarray(jax_make_batch_fn(
        jax_load_generator(TRAINED), mode, local_style_mode, 0.8, 0.7, True,
        True)(batch))
    got = make_batch_fn(model, mode, local_style_mode, 0.8, device="cpu")(batch)
    assert got.dtype == torch.uint8 and got.shape == batch.shape
    if mode == "local_style" and local_style_mode != "simple":
        _assert_levels(ref, got.numpy())
    else:
        assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def chain_batch():
    """A landscape and a pale overcast sky (it trips the has-sky gate)."""
    sky = np.empty((64, 64, 3), np.float32)
    sky[...] = [196.0, 206.0, 222.0]
    sky += np.random.default_rng(7).normal(0, 3, sky.shape)
    return np.stack([render_photo(900150, size=64),
                     np.clip(np.round(sky), 0, 255)]).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_chain_outputs(chain_batch):
    """The JAX program's outputs per (mode, enhance_colors, smooth), built
    once for both engines' cases."""
    jax_model = jax_load_generator(TRAINED)
    cache = {}

    def get(local_style_mode, enhance_colors, smooth):
        key = (local_style_mode, enhance_colors, smooth)
        if key not in cache:
            cache[key] = np.asarray(jax_make_batch_fn(
                jax_model, "local_style", local_style_mode, 0.8, 0.7,
                enhance_colors, smooth)(chain_batch))
        return cache[key]

    return get


@pytest.mark.parametrize("engine", ["nhwc", "packed"])
@pytest.mark.parametrize("local_style_mode,enhance_colors,smooth", [
    ("enhanced", True, True), ("enhanced", False, False),
    ("enhanced", True, False), ("enhanced", False, True),
    ("advanced", True, True)])
def test_post_chain_program_matches_jax(model, chain_batch, jax_chain_outputs,
                                        engine, local_style_mode,
                                        enhance_colors, smooth):
    """The whole uint8 program with each post chain, each engine, colour
    boost and smoothing on and off, against the JAX program."""
    got = make_batch_fn(model, "local_style", local_style_mode, 0.8, 0.7,
                        enhance_colors, smooth, engine=engine,
                        device="cpu")(chain_batch)
    assert got.dtype == torch.uint8 and got.shape == chain_batch.shape
    _assert_levels(jax_chain_outputs(local_style_mode, enhance_colors, smooth),
                   got.numpy())


@pytest.mark.parametrize("kwargs,match", [
    (dict(engine="int4"), "engine must be one of"),
])
def test_batch_fn_raises_for_what_is_not_ported(model, kwargs, match):
    """An engine that does not exist raises (int8 was the one not ported:
    tests/test_torch_int8.py holds it against JAX since)."""
    with pytest.raises(ValueError, match=match):
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


@pytest.mark.parametrize("local_style_mode", ["enhanced", "advanced"])
def test_batch_process_local_style_writes_every_image(model, tmp_path,
                                                      local_style_mode):
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    sizes = [(80, 50), (64, 64)]
    names = _write_images(src, sizes)
    stats = batch_process(model, src, out, mode="local_style",
                          local_style_mode=local_style_mode, batch_size=2,
                          canvas=64, decode_workers=2, device="cpu")
    assert stats["processed"] == 2
    for name, size in zip(names, sizes):
        path = out / f"local_style_{local_style_mode}_photo2monet" / name
        with Image.open(path) as img:
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


def test_server_local_style_enhanced_request(model):
    service = StyleTransferService(model, canvas=64, max_batch=2,
                                   max_wait_ms=1.0, mode="local_style",
                                   local_style_mode="enhanced", device="cpu")
    try:
        body = service.stylize_bytes(_png_bytes(50, 40, seed=5))
        assert Image.open(io.BytesIO(body)).size == (50, 40)
        assert service.stats()["requests"] == 1
    finally:
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
    ("direct_transform", ["--image", "x.png", "--model", TRAINED]),
    ("advanced_transform", ["--image", "x.png", "--model", TRAINED]),
    ("enhanced_local_style", ["--image", "x.png", "--model", TRAINED]),
    ("improved_smooth", ["--input", "x.png", "--original", "y.png",
                         "--output", "z.png"]),
])
def test_clis_exit_nonzero_without_cuda(monkeypatch, capsys, cli, argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(
        f"multi_style_transfer_gan_tpu_torch.cli.{cli}").main
    assert main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_batch_cli_data_parallel_is_not_ported(monkeypatch, capsys):
    """The flag was refused (exit 2) until it was ported: now it parses,
    and without a CUDA device the run stops at the device check like any
    other (tests/test_torch_parallel.py holds ``devices=`` against JAX)."""
    from multi_style_transfer_gan_tpu_torch.cli.batch_process_images import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--data_parallel"]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "not ported" not in err


def test_port_never_imports_jax():
    """Importing the port and every submodule, the study scripts of
    ``scripts/`` among them, leaves jax, the JAX package and the JAX repo's
    ``scripts`` out of sys.modules (a fresh interpreter, since the tests
    themselves use JAX)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multi_style_transfer_gan_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "study = {pkg.__name__ + '.scripts.' + n for n in (\n"
        "    'make_synthetic_domains', 'select_checkpoints',\n"
        "    'make_sample_grids', 'reproduce_quality_study',\n"
        "    'run_trained_surface')}\n"
        "assert study <= set(sys.modules), study - set(sys.modules)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'multi_style_transfer_gan_tpu', 'scripts'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith(pkg.__name__)]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imported_roots(path):
    """The top-level package of every import statement in ``path``
    (relative imports give '')."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add("" if node.level else node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_import_nothing_of_jax():
    """No import statement in the package (its study scripts too) or in
    chip_smoke.py names jax, the JAX package or the JAX repo's
    ``scripts``, wherever it stands (inside functions too)."""
    pkg = os.path.join(REPO, "multi_style_transfer_gan_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 40
    assert os.path.join(pkg, "scripts", "run_trained_surface.py") in paths
    bad = {os.path.relpath(p, REPO): sorted(r) for p in paths
           if (r := _imported_roots(p) & {"jax", "jaxlib", "scripts",
                                          "multi_style_transfer_gan_tpu"})}
    assert not bad, bad
