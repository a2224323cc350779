"""The port's six evaluation CLIs against the JAX package's on the CPU (the
port's ``DEVICE`` replaced, as in tests/test_torch_single_image.py), on the
same folders: the printed numbers, to the last digit each format prints
(or 1e-5 relative), and the workbooks cell by cell (tests/test_torch_metrics.py's limits).
Without a CUDA device each of them exits 1."""

import contextlib
import io
import os
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from multi_style_transfer_gan_tpu.cli import compare_image_quality as jax_ciq
from multi_style_transfer_gan_tpu.cli import complete_comparison as jax_cc
from multi_style_transfer_gan_tpu.cli import image_quality_comparison as jax_iqc
from multi_style_transfer_gan_tpu.cli import improved_image_compare as jax_iic
from multi_style_transfer_gan_tpu.cli import m_test as jax_m_test
from multi_style_transfer_gan_tpu.cli import prepare_comparison_folders as jax_pcf
from multi_style_transfer_gan_tpu.metrics import fid_harness as jax_harness
from multi_style_transfer_gan_tpu_torch.cli import compare_image_quality
from multi_style_transfer_gan_tpu_torch.cli import complete_comparison
from multi_style_transfer_gan_tpu_torch.cli import image_quality_comparison
from multi_style_transfer_gan_tpu_torch.cli import improved_image_compare
from multi_style_transfer_gan_tpu_torch.cli import m_test
from multi_style_transfer_gan_tpu_torch.cli import prepare_comparison_folders
from multi_style_transfer_gan_tpu_torch.metrics import fid_harness as port_harness
from test_torch_metrics import MSE_RTOL, SSIM_ATOL, _assert_same_cells
from torch_oracle import make_enhanced_sd

CLIS = (compare_image_quality, complete_comparison, image_quality_comparison,
        improved_image_compare, m_test, prepare_comparison_folders)
_NUMBER = re.compile(r"-?\d+\.\d+(?:e-?\d+)?|-?\d+")


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cli in CLIS:
        if hasattr(cli, "DEVICE"):
            monkeypatch.setattr(cli, "DEVICE", "cpu")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """photos/ and two stylized-looking folders (out1 less noisy than out2)
    of JPEGs at two sizes, one PNG, one image out1 lacks."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(8)
    dirs = {n: root / n for n in ("photos", "out1", "out2")}
    for d in dirs.values():
        d.mkdir()
    for name, (w, h) in {"p0.jpg": (72, 48), "p1.jpg": (72, 48),
                         "p2.png": (64, 64), "p3.jpg": (64, 64)}.items():
        base = (rng.random((h // 8, w // 8, 3)) * 255).astype(np.uint8)
        base = np.asarray(Image.fromarray(base).resize((w, h), Image.BICUBIC))
        Image.fromarray(base).save(dirs["photos"] / name, quality=95)
        for d, noise in (("out1", 8), ("out2", 16)):
            if d == "out1" and name == "p3.jpg":
                continue
            arr = np.clip(base + rng.normal(0, noise, base.shape), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(dirs[d] / name,
                                                       quality=95)
    return {k: str(v) for k, v in dirs.items()}


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _assert_same_output(got, want, rtol=1e-5):
    """The same text, and each number within one unit of the last digit it
    was printed with or ``rtol`` (PSNR is printed with six decimals by
    image_quality_comparison, where the two sides differ by ~3e-5 dB)."""
    assert _NUMBER.sub("#", got) == _NUMBER.sub("#", want)
    for g, w in zip(_NUMBER.findall(got), _NUMBER.findall(want)):
        digits = len(w.split(".")[1]) if "." in w and "e" not in w else 0
        np.testing.assert_allclose(float(g), float(w), rtol=rtol,
                                   atol=1.01 * 10.0 ** -digits if digits
                                   else 0, err_msg=f"{g} vs {w}")


def _both(jax_cli, cli, argv, tmp_path, out_flag="--output_dir"):
    """Run both CLIs on ``argv``, each writing under its own directory; the
    two outputs with the directories named alike."""
    runs = {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        extra = [out_flag, str(tmp_path / side)] if out_flag else []
        rc, text = _run(main, argv + extra)
        assert rc in (None, 0), (side, rc, text)
        runs[side] = text.replace(str(tmp_path / side), "OUT")
    return runs["port"], runs["jax"]


@pytest.mark.parametrize("mode", ["compare_dirs", "auto_detect",
                                  "with_test_images"])
def test_compare_image_quality_cli_matches_jax(on_cpu, folders, tmp_path,
                                               mode):
    argv = ["--base_dir", folders["photos"]]
    if mode == "compare_dirs":
        argv += ["--compare_dirs", folders["out1"], folders["out2"]]
        xlsx = "comparison_results.xlsx"
    elif mode == "auto_detect":
        argv += ["--auto_detect", "--output_prefix", "sib"]
        xlsx = "sib_results.xlsx"
    else:
        argv = ["--base_dir", folders["out1"], "--compare_dirs",
                folders["out2"], "--with_test_images", folders["photos"]]
        xlsx = "detailed_metrics_comparison.xlsx"
    got, want = _both(jax_ciq, compare_image_quality, argv, tmp_path)
    _assert_same_output(got, want)
    assert ("verdict: cyclegan wins 9/9" in got) == (mode == "with_test_images")
    _assert_same_cells(tmp_path / "port" / xlsx, tmp_path / "jax" / xlsx,
                       rtol=MSE_RTOL, atol=SSIM_ATOL)


def test_compare_image_quality_cli_needs_compare_dirs(on_cpu, folders):
    rc, text = _run(compare_image_quality.main,
                    ["--base_dir", folders["photos"], "--with_test_images",
                     folders["photos"]])
    assert rc == 1 and "requires --compare_dirs" in text


def test_complete_comparison_cli_matches_jax(on_cpu, folders, tmp_path):
    argv = ["--original_dir", folders["photos"], "--folder_a",
            folders["out2"], "--folder_b", folders["out1"], "--name_a", "A",
            "--name_b", "B"]
    got, want = _both(jax_cc, complete_comparison, argv, tmp_path)
    _assert_same_output(got, want)
    assert "images compared: 3" in got and "verdict: B wins 9/9" in got
    xlsx = "detailed_metrics_comparison.xlsx"
    _assert_same_cells(tmp_path / "port" / xlsx, tmp_path / "jax" / xlsx,
                       rtol=MSE_RTOL, atol=SSIM_ATOL)


def test_image_quality_comparison_cli_matches_jax(on_cpu, folders, tmp_path):
    argv = ["--dir_a", folders["photos"], "--dir_b", folders["out2"]]
    got, want = _both(jax_iqc, image_quality_comparison, argv, tmp_path)
    _assert_same_output(got, want)
    xlsx = "image_comparison_results.xlsx"
    _assert_same_cells(tmp_path / "port" / xlsx, tmp_path / "jax" / xlsx,
                       rtol=MSE_RTOL, atol=SSIM_ATOL)
    assert os.path.exists(tmp_path / "port" /
                          "image_comparison_results_charts.png")


def test_improved_image_compare_cli_matches_jax(on_cpu, folders, tmp_path):
    argv = ["--original_dir", folders["photos"], "--folder_a",
            folders["out1"], "--folder_b", folders["out2"]]
    got, want = _both(jax_iic, improved_image_compare, argv, tmp_path,
                      out_flag=None)
    _assert_same_output(got, want)
    assert got.count("-> cyclegan better") == 9
    assert got.rstrip().endswith("overall: cyclegan wins 9/9 metric "
                                 "comparisons")
    assert os.listdir(tmp_path) == []   # console only


def test_prepare_comparison_folders_cli_matches_jax(on_cpu, folders,
                                                    tmp_path):
    texts = {}
    for side, main in (("jax", jax_pcf.main),
                       ("port", prepare_comparison_folders.main)):
        src = tmp_path / side
        shutil.copytree(folders["out1"], src)
        rc, text = _run(main, ["--src_dir", str(src), "--prefix", "p",
                               "--dest_name", "clean"])
        assert rc in (None, 0)
        texts[side] = text.replace(str(src), "SRC")
    assert texts["port"] == texts["jax"]
    assert texts["port"].startswith("prepared 3 files")
    assert sorted(os.listdir(tmp_path / "port" / "clean")) == \
        ["0.jpg", "1.jpg", "2.png"]


def test_m_test_cli_matches_jax(on_cpu, monkeypatch, tmp_path):
    """Both generators from .pth files through ``load_generator`` on the
    CLI's device, the fallback features, 2 of 3 test images a side.

    The fallback features are cut to their 8 x 8 scale on both sides (the
    last 194 of 4038 columns), so the statistic's four ``eigh`` a run are
    194-dimensional: at 4038 they take seconds each and thrash the BLAS
    threads of the other test workers. tests/test_torch_fid.py holds the
    whole harness at full width."""
    for harness in (jax_harness, port_harness):
        monkeypatch.setattr(harness, "default_feature_fn",
                            lambda x, full=harness.default_feature_fn:
                            full(x)[:, -194:])
    rng = np.random.default_rng(12)
    data = tmp_path / "data"
    for dom in ("A", "B"):
        (data / f"test{dom}").mkdir(parents=True)
        for i in range(3):
            Image.fromarray((rng.random((64, 80, 3)) * 255).astype(
                np.uint8)).save(data / f"test{dom}" / f"{i}.jpg")
    for key in ("G_AB", "G_BA"):
        torch.save({f"{key}_state_dict": make_enhanced_sd(rng, c=4)},
                   tmp_path / f"{key}.pth")
    argv = ["--data_root", str(data), "--g_ab", str(tmp_path / "G_AB.pth"),
            "--g_ba", str(tmp_path / "G_BA.pth"), "--max_images", "2"]
    got, want = _both(jax_m_test, m_test, argv, tmp_path / "out")
    _assert_same_output(got, want, rtol=1e-4)
    assert "(2 generated vs 2 real)" in got
    assert (tmp_path / "out" / "port" / "test_results.txt").read_text() \
        .startswith("monet2photo FID: ")
    assert os.path.exists(tmp_path / "out" / "port" / "panels_photo2monet.png")


@pytest.mark.parametrize("cli", CLIS, ids=lambda c: c.__name__.rsplit(".")[-1])
def test_cli_exits_1_without_a_cuda_device(monkeypatch, capsys, tmp_path, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"compare_image_quality": ["--base_dir", str(tmp_path)],
            "complete_comparison": ["--original_dir", "a", "--folder_a", "b",
                                    "--folder_b", "c"],
            "image_quality_comparison": ["--dir_a", "a", "--dir_b", "b"],
            "improved_image_compare": ["--original_dir", "a", "--folder_a",
                                       "b", "--folder_b", "c"],
            "m_test": ["--data_root", str(tmp_path)],
            "prepare_comparison_folders": ["--src_dir", str(tmp_path)]}
    assert cli.main(argv[cli.__name__.rsplit(".")[-1]]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
