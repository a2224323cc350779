"""The port's quality metrics, FID statistic, workbook writer and folder
evaluation (``multi_style_transfer_gan_tpu_torch.metrics``) against the JAX
package's on the CPU, on the same numpy inputs and the same JPEG folders.

Tolerances: MSE relative 1e-4 and PSNR 5e-4 dB (one fp32 mean of squares
summed in another order: up to 7e-6 relative, 3e-5 dB, on an 80 x 80
image), SSIM 1e-5 absolute (the window means are an average pool
here and a 1/49-weighted convolution there: a few ulps, which the
uxx - ux * ux cancellation lifts to ~2e-6 on smooth images), the Frechet
statistic 1e-10 relative (the same float64 host code)."""

import os
import shutil
import xml.etree.ElementTree as ET
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from multi_style_transfer_gan_tpu.metrics import evaluation as jeval
from multi_style_transfer_gan_tpu.metrics import fid as jfid
from multi_style_transfer_gan_tpu.metrics import quality as jquality
from multi_style_transfer_gan_tpu.metrics import report as jreport
from multi_style_transfer_gan_tpu_torch.metrics import evaluation as teval
from multi_style_transfer_gan_tpu_torch.metrics import fid as tfid
from multi_style_transfer_gan_tpu_torch.metrics import quality as tquality
from multi_style_transfer_gan_tpu_torch.metrics import report as treport

MSE_RTOL, PSNR_ATOL, SSIM_ATOL = 1e-4, 5e-4, 1e-5
TOL = {"mse": dict(rtol=MSE_RTOL, atol=0), "psnr": dict(rtol=0, atol=PSNR_ATOL),
       "ssim": dict(rtol=0, atol=SSIM_ATOL)}


def _smooth(rng, shape):
    """Low-variance images (the cancellation's hard case): a blurred noise
    field through a steep tone curve, clipped to [0, 1]."""
    from scipy.ndimage import gaussian_filter

    sigma = (0,) * (len(shape) - 3) + (6, 6, 0)
    return np.clip(gaussian_filter(rng.random(shape), sigma) * 3 - 1, 0, 1)


def _pair(kind, shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-2])
    if kind == "random":
        a, b = rng.random(shape), rng.random(shape)
    elif kind == "smooth":
        a = _smooth(rng, shape)
        b = np.clip(a + rng.normal(0, 0.02, shape), 0, 1)
    else:
        a = rng.random(shape)
        b = a
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "smooth", "identical"])
@pytest.mark.parametrize("shape", [(64, 48, 3), (2, 64, 48, 3),
                                   (3, 256, 256, 3)])
@pytest.mark.parametrize("metric", ["mse", "psnr", "ssim"])
def test_metric_matches_jax(metric, shape, kind):
    a, b = _pair(kind, shape)
    want = np.asarray(getattr(jquality, metric)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tquality, metric)(torch.from_numpy(a),
                                    torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == shape[:-3]
    np.testing.assert_allclose(got, want, **TOL[metric])
    if kind == "identical" and metric == "ssim":
        np.testing.assert_array_equal(got, 1.0)


def test_compare_pair_matches_jax():
    a, b = _pair("smooth", (2, 64, 48, 3))
    want = jquality.compare_pair(jnp.asarray(a), jnp.asarray(b))
    got = tquality.compare_pair(torch.from_numpy(a), torch.from_numpy(b))
    assert set(got) == set(want) == {"mse", "psnr", "ssim"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL[k])


def test_fid_statistics_match_jax():
    rng = np.random.default_rng(5)
    fa = rng.normal(0, 1, (40, 24))
    fb = rng.normal(0.3, 1.2, (36, 24)) @ rng.normal(0, 0.4, (24, 24))
    np.testing.assert_allclose(tfid.fid_from_features(fa, fb),
                               jfid.fid_from_features(fa, fb), rtol=1e-10)
    mu1, mu2 = fa.mean(0), fb.mean(0)
    s1, s2 = np.cov(fa, rowvar=False), np.cov(fb, rowvar=False)
    got = tfid.frechet_distance(mu1, s1, mu2, s2)
    np.testing.assert_allclose(got, jfid.frechet_distance(mu1, s1, mu2, s2),
                               rtol=1e-10)
    assert got > 0
    assert abs(tfid.fid_from_features(fa, fa)) < 1e-6


# ---------------------------------------------------------------------------
# workbooks
# ---------------------------------------------------------------------------

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def _cells(path):
    """{sheet name: {cell ref: value}} of an .xlsx written by write_xlsx:
    numbers as floats, inline strings as str, booleans as bool."""
    with zipfile.ZipFile(path) as z:
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        names = [s.get("name") for s in wb.find("m:sheets", _NS)]
        out = {}
        for i, name in enumerate(names):
            sheet = ET.fromstring(z.read(f"xl/worksheets/sheet{i + 1}.xml"))
            cells = {}
            for c in sheet.iter(f"{{{_NS['m']}}}c"):
                if c.get("t") == "inlineStr":
                    cells[c.get("r")] = "".join(c.itertext())
                elif c.get("t") == "b":
                    cells[c.get("r")] = bool(int(c.find("m:v", _NS).text))
                else:
                    cells[c.get("r")] = float(c.find("m:v", _NS).text)
            out[name] = cells
    return out


def _assert_same_cells(got_path, want_path, rtol=0.0, atol=0.0):
    got, want = _cells(got_path), _cells(want_path)
    assert list(got) == list(want)
    for sheet in want:
        assert set(got[sheet]) == set(want[sheet]), sheet
        for ref, v in want[sheet].items():
            g = got[sheet][ref]
            if isinstance(v, float) and not isinstance(v, bool):
                np.testing.assert_allclose(g, v, rtol=rtol, atol=atol,
                                           err_msg=f"{sheet}!{ref}")
            else:
                assert g == v, f"{sheet}!{ref}: {g!r} vs {v!r}"


def test_write_xlsx_matches_jax(tmp_path):
    sheets = {"Detailed": [["image", "mse", "ok"], ["a & <b>.jpg", 0.25, True],
                           ["c.jpg", np.float32(1.5), None],
                           ["d.jpg", np.float64(np.inf), np.int64(3)]],
              "Win Statistics": [["metric", "rate"], ["ssim", 66.6]]}
    treport.write_xlsx(tmp_path / "port.xlsx", sheets)
    jreport.write_xlsx(tmp_path / "jax.xlsx", sheets)
    _assert_same_cells(tmp_path / "port.xlsx", tmp_path / "jax.xlsx")
    cells = _cells(tmp_path / "port.xlsx")
    assert cells["Detailed"]["A2"] == "a & <b>.jpg"
    assert cells["Detailed"]["B3"] == 1.5 and cells["Detailed"]["C2"] is True


# ---------------------------------------------------------------------------
# folders
# ---------------------------------------------------------------------------

def _save(path, arr):
    Image.fromarray(arr).save(path, quality=92)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """base/ and three result folders of JPEG/PNG images of mixed sizes:
    out1 and out2 share a, b, d with base (b at another size in out1, so it
    is resized to match), out1's c is a byte copy of base's (the identical
    guard); nested/out1 shares base's basename with out1; e is only in
    base; other/ shares nothing."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(21)
    dirs = {n: root / n for n in ("base", "out1", "out2", "other")}
    dirs["nested"] = root / "nested" / "out1"
    for d in dirs.values():
        d.mkdir(parents=True)
    sizes = {"a.jpg": (96, 64), "b.jpg": (96, 64), "c.jpg": (80, 80),
             "d.png": (80, 80), "e.jpg": (64, 48)}
    for name, (w, h) in sizes.items():
        base = (_smooth(rng, (h, w, 3)) * 255).astype(np.uint8)
        _save(dirs["base"] / name, base)
        if name == "e.jpg":
            continue
        for d, noise in (("out1", 12), ("out2", 20), ("nested", 6)):
            arr = np.clip(base + rng.normal(0, noise, base.shape), 0,
                          255).astype(np.uint8)
            if d == "out1" and name == "b.jpg":
                arr = np.asarray(Image.fromarray(arr).resize((120, 80)))
            _save(dirs[d] / name, arr)
    shutil.copy(dirs["base"] / "c.jpg", dirs["out1"] / "c.jpg")
    _save(dirs["other"] / "x.jpg", np.zeros((32, 32, 3), np.uint8))
    return {k: str(v) for k, v in dirs.items()}


def _assert_same_folder_result(got, want):
    assert list(got["per_image"]) == list(want["per_image"])
    assert got["skipped"] == want["skipped"]
    for name, m in want["per_image"].items():
        for k in m:
            np.testing.assert_allclose(got["per_image"][name][k], m[k],
                                       **TOL[k], err_msg=f"{name} {k}")
    assert list(got["average"]) == list(want["average"])
    for k, v in want["average"].items():
        np.testing.assert_allclose(got["average"][k], v, **TOL[k])


def test_compare_folder_pair_matches_jax(folders):
    want = jeval.compare_folder_pair(folders["base"], folders["out1"],
                                     batch=1)
    got = teval.compare_folder_pair(folders["base"], folders["out1"],
                                    batch=1, device="cpu")
    assert sorted(got["per_image"]) == ["a.jpg", "b.jpg", "d.png"]
    assert got["skipped"] == [("c.jpg", "identical images")]
    _assert_same_folder_result(got, want)


def test_find_matching_images_matches_jax(folders):
    for other in ("out1", "other"):
        assert teval.find_matching_images(folders["base"], folders[other]) \
            == jeval.find_matching_images(folders["base"], folders[other])


@pytest.mark.parametrize("case", ["auto_detect", "same_basename"])
def test_compare_image_quality_matches_jax(folders, tmp_path, case):
    if case == "auto_detect":
        # the siblings replace the list; nested/ holds no image itself, and
        # other/ has none in common with base/ (no Summary row)
        kwargs = dict(other_dirs=[folders["nested"]], auto_detect=True)
        keys = ["other", "out1", "out2"]
    else:
        kwargs = dict(other_dirs=[folders["out1"], folders["nested"]])
        keys = ["out1", os.path.join("nested", "out1")]
    want = jeval.compare_image_quality(folders["base"], output_dir=str(
        tmp_path / "jax"), **kwargs)
    got = teval.compare_image_quality(folders["base"], output_dir=str(
        tmp_path / "port"), device="cpu", **kwargs)
    assert list(got["results"]) == list(want["results"]) == keys
    for k in keys:
        _assert_same_folder_result(got["results"][k], want["results"][k])
    _assert_same_cells(got["xlsx"], want["xlsx"], rtol=MSE_RTOL,
                       atol=SSIM_ATOL)
    for metric in ("mse", "psnr", "ssim"):
        assert os.path.exists(tmp_path / "port" / f"comparison_{metric}_chart.png")


@pytest.mark.parametrize("folder_b", ["out2", "other"])
def test_complete_comparison_matches_jax(folders, tmp_path, folder_b):
    args = (folders["base"], folders["out1"], folders[folder_b])
    want = jeval.complete_comparison(*args, output_dir=str(tmp_path / "jax"))
    got = teval.complete_comparison(*args, output_dir=str(tmp_path / "port"),
                                    device="cpu")
    assert got["wins"] == want["wins"]
    assert got["verdict"] == want["verdict"]
    assert got["n_images"] == want["n_images"]
    _assert_same_cells(got["xlsx"], want["xlsx"], rtol=MSE_RTOL,
                       atol=SSIM_ATOL)
    if folder_b == "other":
        assert got["verdict"] == "no matching images to compare"
        assert got["n_images"] == 0
    else:
        assert got["n_images"] == 3
        # out1 is the less noisy copy: it wins every metric of every image
        assert got["wins"]["cyclegan"] == {"mse": 3, "psnr": 3, "ssim": 3}
        assert got["verdict"] == "cyclegan wins 9/9 metric comparisons"
        assert os.path.exists(tmp_path / "port" / "comparison_results_charts.png")


def test_complete_comparison_credits_ties_to_name_b(folders, tmp_path):
    got = teval.complete_comparison(folders["base"], folders["out2"],
                                    folders["out2"], output_dir=str(tmp_path),
                                    device="cpu")
    assert got["wins"]["cyclegan"] == {"mse": 0, "psnr": 0, "ssim": 0}
    assert got["wins"]["localstyle"] == {"mse": 4, "psnr": 4, "ssim": 4}
    assert got["verdict"] == "localstyle wins 12/12 metric comparisons"


def test_prepare_comparison_folders_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        for name in ("cyclegan_photo2monet_a.jpg", "cyclegan_photo2monet_b.png",
                     "local_a.jpg"):
            _save(d / name, (rng.random((16, 16, 3)) * 255).astype(np.uint8))
    prefix = "cyclegan_photo2monet_"
    want = jeval.prepare_comparison_folders(str(tmp_path / "jax"), prefix)
    got = teval.prepare_comparison_folders(str(tmp_path / "port"), prefix)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want] == \
        [os.path.join("for_comparison", n) for n in ("a.jpg", "b.png")]
    for p in got:   # copied, the originals left in place
        src = tmp_path / "port" / (prefix + os.path.basename(p))
        assert src.exists() and src.read_bytes() == open(p, "rb").read()


# ---------------------------------------------------------------------------
# the device self-check
# ---------------------------------------------------------------------------

def test_check_metrics_device_passes_once_per_device(monkeypatch):
    checked = set()
    monkeypatch.setattr(tquality, "_CHECKED", checked)
    calls = []
    real = tquality.ssim
    monkeypatch.setattr(tquality, "ssim",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tquality.check_metrics_device("cpu")
    assert checked == {"cpu"} and len(calls) == 3
    tquality.check_metrics_device(torch.device("cpu"))
    assert len(calls) == 3   # once per process and device


@pytest.mark.parametrize("fault", ["disagrees", "identity"])
def test_check_metrics_device_raises_and_never_reroutes(monkeypatch, folders,
                                                        fault):
    """A device whose SSIM disagrees with the CPU's on the probe (the first
    call is the CPU's own), or whose SSIM(x, x) is not 1, stops the folder
    comparison with both values; nothing moves to the CPU."""
    monkeypatch.setattr(tquality, "_CHECKED", set())
    real = tquality.ssim
    returned = []

    def faulty(a, b, *args, **kwargs):
        v = real(a, b, *args, **kwargs)
        if returned:   # the first call is the CPU's reference
            if fault == "disagrees" and a is not b:
                v = v + 2e-3
            if fault == "identity" and a is b:
                v = v - 2e-4
        returned.append(float(v))
        return v

    monkeypatch.setattr(tquality, "ssim", faulty)
    with pytest.raises(RuntimeError, match="disagrees with the CPU") as err:
        teval.compare_folder_pair(folders["base"], folders["out1"],
                                  device="cpu")
    cpu, got, ident = returned
    for v in (cpu, got, ident):
        assert repr(v) in str(err.value)
    assert abs(got - cpu) > 1e-3 if fault == "disagrees" \
        else abs(ident - 1) > 1e-4
    assert not tquality._CHECKED


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest tests/ -m gpu` "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "smooth", "identical"])
def test_metrics_on_the_card_match_cpu(cuda, monkeypatch, kind):
    """With every TF32 switch on (PyTorch's cuDNN default): SSIM within
    1e-4 per image, PSNR 1e-3 dB, MSE 1e-5 relative (chip_smoke.py's
    limits); SSIM(x, x) = 1 within 1e-6; the probe passes."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(tquality, "_CHECKED", set())
    tquality.check_metrics_device(cuda)
    a, b = (torch.from_numpy(x) for x in _pair(kind, (4, 256, 256, 3)))
    want = tquality.compare_pair(a, b)
    got = {k: v.cpu() for k, v in tquality.compare_pair(a.to(cuda),
                                                        b.to(cuda)).items()}
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-5, atol=0)
    ident = tquality.ssim(a.to(cuda), a.to(cuda)).cpu()
    np.testing.assert_allclose(ident, 1.0, rtol=0, atol=1e-6)
