"""The trained-model study on the port (``multi_style_transfer_gan_tpu_torch
.scripts``) against the JAX repo's ``scripts/`` on the CPU (each script's
``DEVICE`` replaced, as in tests/test_torch_eval_cli.py): the synthetic
domains byte for byte, ``forward_u8`` in fp32 and bf16, the soup bit for
bit, checkpoint selection, the quality study's smoke and real mode, the
surface's staging and conversion, and the two batch menus through a stub
``python``. The ``gpu``-marked tests hold ``forward_u8`` and the soup
export on the card against the CPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from multi_style_transfer_gan_tpu_torch.models import EnhancedGenerator
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from multi_style_transfer_gan_tpu_torch.scripts import (
    make_sample_grids, make_synthetic_domains, reproduce_quality_study,
    run_trained_surface, select_checkpoints,
)
from multi_style_transfer_gan_tpu_torch.weights import (
    load_pth, state_dict_from_jax_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_synthetic_domains as jax_msd  # noqa: E402
import reproduce_quality_study as jax_rqs  # noqa: E402
import run_trained_surface as jax_rts  # noqa: E402
import select_checkpoints as jax_sc  # noqa: E402

TRAINED = os.path.join(REPO, "trained")
SCRIPTS = (make_sample_grids, reproduce_quality_study, run_trained_surface,
           select_checkpoints)
# the uint8 program's limit (PERF.md section 2): at most 1 level apart, on
# at most 1% of the values
PROGRAM_MAX, PROGRAM_SHARE = 1, 0.01
# mean SSIM of the fp32 forwards, port vs JAX: PERF.md section 2's SSIM
# limit; a report rounds to 4 digits, so its values may differ by one more
# rounding step
SSIM_ATOL = 1e-4
REPORT_ATOL = SSIM_ATOL + 1e-4
# bf16 forwards: each framework rounds at its own points, and at the
# trained c16 weights both land far from fp32 on a few pixels (up to 56 and
# 72 levels, < 1% of the values past 2 levels). The port's bf16 output is
# held to be no farther from the fp32 reference than JAX's own bf16 output
# is, by a factor of BF16_FACTOR on the mean |d| and on the share past 2
# levels, and its mean SSIM within BF16_SSIM_ATOL of JAX's bf16 one (each
# side's bf16 SSIM moved ~1.2e-3 from fp32, the two ~2.3e-3 apart)
BF16_FACTOR, BF16_SSIM_ATOL = 1.25, 5e-3
# the quality study's averages, port vs JAX: PERF.md section 2's metric
# limits. The local-style outputs carry the post chain's last-ulp ties
# (tests/test_torch_pipelines.py holds that program at > 1 level on <= 0.1%
# of the values), which the JPEG save spreads over 8 x 8 blocks: their MSE
# is held at test_torch_metrics.py's port-vs-JAX limit, 1e-4 relative
# (5.0e-5 measured; PSNR 2.2e-4 dB, SSIM 6.5e-6)
STUDY_TOL = {"mse": dict(rtol=1e-5, atol=0), "psnr": dict(rtol=0, atol=1e-3),
             "ssim": dict(rtol=0, atol=1e-4)}
LOCAL_STYLE_MSE_RTOL = 1e-4


@pytest.fixture
def on_cpu(monkeypatch):
    """Every study script on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for mod in SCRIPTS:
        monkeypatch.setattr(mod, "DEVICE", "cpu")


@pytest.fixture(scope="module")
def domains(tmp_path_factory):
    """The synthetic domains at 64^2: 2 training and 4 test images a
    domain."""
    root = str(tmp_path_factory.mktemp("study") / "domains")
    make_synthetic_domains.main(["--root", root, "--n_train", "2",
                                 "--n_test", "4", "--size", "64"])
    return root


def _trained_sd(key):
    return load_pth(os.path.join(TRAINED, f"G_{key}_selected.pth")
                    )[f"G_{key}_state_dict"]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# ---------------------------------------------------------------------------
# the domains, forward_u8, the soup
# ---------------------------------------------------------------------------

def test_make_synthetic_domains_writes_the_jax_bytes(tmp_path, capsys):
    argv = ["--n_train", "2", "--n_test", "2", "--size", "64"]
    make_synthetic_domains.main(["--root", str(tmp_path / "port")] + argv)
    port_line = json.loads(capsys.readouterr().out)
    jax_msd.main(["--root", str(tmp_path / "jax")] + argv)
    jax_line = json.loads(capsys.readouterr().out)
    for line in (port_line, jax_line):
        line.pop("root"), line.pop("seconds")
    assert port_line == jax_line
    names = _files(tmp_path / "jax")
    assert len(names) == 12 and _files(tmp_path / "port") == names
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes()), n


@pytest.fixture(scope="module")
def forwards(domains):
    """The trained G_BA on the last 2 testB images at 256^2 (padded to a
    chunk of 8), port and JAX, in fp32 (JAX's input still rounded to bf16)
    and in bf16."""
    from multi_style_transfer_gan_tpu.pipelines import (
        load_generator as jax_load_generator,
    )

    inputs, truth = select_checkpoints.make_eval("BA", domains, 2)
    jax_inputs, jax_truth = jax_sc.make_eval("BA", domains, 2)
    assert (inputs == jax_inputs).all() and (truth == jax_truth).all()
    path = os.path.join(TRAINED, "G_BA_selected.pth")
    port, jm = load_generator(path, device="cpu"), jax_load_generator(path)
    fp32 = lambda x: jm.apply(x.astype(jnp.float32))
    return {"truth": truth, "inputs": inputs,
            "port32": select_checkpoints.forward_u8(
                port, inputs, compute_dtype=torch.float32),
            "jax32": jax_sc.forward_u8(fp32, inputs),
            "port16": select_checkpoints.forward_u8(port, inputs),
            "jax16": jax_sc.forward_u8(jm.apply, inputs)}


def _levels(a, b):
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


def test_forward_u8_fp32_matches_jax(forwards):
    got, want = forwards["port32"], forwards["jax32"]
    assert got.dtype == np.uint8 and got.shape == (2, 256, 256, 3)
    d = _levels(got, want)
    assert d.max() <= PROGRAM_MAX and (d > 0).mean() <= PROGRAM_SHARE
    truth = forwards["truth"]
    assert abs(select_checkpoints.mean_ssim(got, truth, "cpu")
               - jax_sc.mean_ssim(want, truth)) <= SSIM_ATOL


def test_forward_u8_bf16_matches_jax(forwards):
    ref = forwards["jax32"]
    port, jax_ = (_levels(forwards[k], ref) for k in ("port16", "jax16"))
    assert port.mean() <= BF16_FACTOR * jax_.mean()
    assert (port > 2).mean() <= BF16_FACTOR * (jax_ > 2).mean()
    truth = forwards["truth"]
    assert abs(select_checkpoints.mean_ssim(forwards["port16"], truth, "cpu")
               - jax_sc.mean_ssim(forwards["jax16"], truth)
               ) <= BF16_SSIM_ATOL


def test_forward_u8_pads_the_last_chunk_and_keeps_the_batch(domains):
    """3 images in chunks of 2 == the same images one by one."""
    inputs, _ = select_checkpoints.make_eval("AB", domains, 3)
    model = load_generator(os.path.join(TRAINED, "G_AB_selected.pth"),
                           device="cpu")
    small = np.ascontiguousarray(inputs[:, ::4, ::4])   # 64^2
    chunked = select_checkpoints.forward_u8(model, small, batch=2,
                                            compute_dtype=torch.float32)
    one = np.concatenate([select_checkpoints.forward_u8(
        model, small[i:i + 1], batch=1, compute_dtype=torch.float32)
        for i in range(3)])
    assert chunked.shape == small.shape
    d = _levels(chunked, one)
    assert d.max() <= PROGRAM_MAX and (d > 0).mean() <= PROGRAM_SHARE


def _stage_epochs(models_dir, epochs, seed):
    """G_{AB,BA}_epoch_{e}.pth as the train CLI writes them: the trained
    pair plus a seeded perturbation per epoch."""
    os.makedirs(models_dir, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    for e in epochs:
        for key in ("AB", "BA"):
            sd = {k: v + 0.02 * v.abs().mean() * torch.randn(v.shape,
                                                              generator=g)
                  for k, v in _trained_sd(key).items()}
            torch.save({f"G_{key}_state_dict": sd, "epoch": e},
                       os.path.join(models_dir, f"G_{key}_epoch_{e}.pth"))


def test_soup_state_dict_is_bit_equal_to_jax(tmp_path):
    _stage_epochs(str(tmp_path), (1, 2, 3), seed=3)
    paths = [str(tmp_path / f"G_BA_epoch_{e}.pth") for e in (1, 2, 3)]
    got = select_checkpoints.soup_state_dict(paths, "G_BA_state_dict")
    want = jax_sc.soup_state_dict(paths, "G_BA_state_dict")
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32
        assert torch.equal(got[k], v), k


# ---------------------------------------------------------------------------
# select_checkpoints.main, make_sample_grids.main
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_epochs(tmp_path_factory):
    """Two epochs of seeded c4 generators."""
    models = str(tmp_path_factory.mktemp("epochs"))
    for e in (1, 2):
        for i, key in enumerate(("AB", "BA")):
            m = EnhancedGenerator(4, 1, generator=torch.Generator()
                                  .manual_seed(10 * e + i))
            torch.save({f"G_{key}_state_dict": m.state_dict(), "epoch": e},
                       os.path.join(models, f"G_{key}_epoch_{e}.pth"))
    return models


def _fp32_forwards(monkeypatch):
    """Both scripts' forward_u8 in fp32 (JAX's input still rounded to
    bf16), a chunk the size of the validation set."""
    port, jax_ = select_checkpoints.forward_u8, jax_sc.forward_u8
    monkeypatch.setattr(select_checkpoints, "forward_u8",
                        lambda m, x, batch=8: port(
                            m, x, len(x), compute_dtype=torch.float32))
    monkeypatch.setattr(jax_sc, "forward_u8", lambda f, x, batch=8: jax_(
        lambda v: f(v.astype(jnp.float32)), x, len(x)))


def test_select_checkpoints_main_matches_jax(on_cpu, monkeypatch, domains,
                                             tiny_epochs, tmp_path, capsys):
    _fp32_forwards(monkeypatch)
    argv = ["--models_dir", tiny_epochs, "--data_root", domains,
            "--n_val", "2", "--soup_max", "2"]
    assert select_checkpoints.main(
        argv + ["--selected_dir", str(tmp_path / "port")]) == 0
    port_picks = capsys.readouterr().out.strip().splitlines()[-1]
    assert jax_sc.main(argv + ["--selected_dir", str(tmp_path / "jax")]) == 0
    assert port_picks == capsys.readouterr().out.strip().splitlines()[-1]
    got, want = (json.loads((tmp_path / d / "selection_report.json")
                            .read_text()) for d in ("port", "jax"))

    def flat(report, path=""):
        if isinstance(report, dict):
            return {k2: v2 for k, v in report.items()
                    for k2, v2 in flat(v, f"{path}/{k}").items()}
        if isinstance(report, list):
            return {k2: v2 for i, v in enumerate(report)
                    for k2, v2 in flat(v, f"{path}/{i}").items()}
        return {path: report}

    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith("ssim"):
            assert abs(got[k] - v) <= REPORT_ATOL, k
        else:
            assert got[k] == v, k
    for key in ("AB", "BA"):
        ours = load_pth(str(tmp_path / "port" / f"G_{key}_epoch_0.pth"))
        theirs = torch.load(str(tmp_path / "jax" / f"G_{key}_epoch_0.pth"),
                            map_location="cpu", weights_only=False)
        assert set(ours) == set(theirs) == {f"G_{key}_state_dict", "epoch"}
        assert ours["epoch"] == theirs["epoch"]
        for k, v in theirs[f"G_{key}_state_dict"].items():
            assert torch.equal(ours[f"G_{key}_state_dict"][k], v), k


def test_make_sample_grids_main(on_cpu, monkeypatch, domains, tmp_path):
    """Rows of input | output | truth for the first --n test images a
    direction, as JPEG at quality 92, from the selected pair."""
    sel = tmp_path / "selected"
    sel.mkdir()
    for key in ("AB", "BA"):
        shutil.copy(os.path.join(TRAINED, f"G_{key}_selected.pth"),
                    sel / f"G_{key}_epoch_0.pth")
    seen = []
    real = make_sample_grids.forward_u8
    monkeypatch.setattr(make_sample_grids, "forward_u8", lambda m, x: (
        seen.append(x.shape), real(m, x, compute_dtype=torch.float32))[1])
    assert make_sample_grids.main(
        ["--selected_dir", str(sel), "--data_root", domains,
         "--output_dir", str(tmp_path / "grids"), "--n", "2"]) == 0
    assert seen == [(2, 256, 256, 3)] * 2
    for label, src, truth in (("photo2monet", "testB", "truth_monet_for_testB"),
                              ("monet2photo", "testA",
                               "truth_photo_for_testA")):
        with Image.open(tmp_path / "grids"
                        / f"{label}_input_output_truth.jpg") as img:
            assert img.size == (768, 512) and img.format == "JPEG"
            grid = np.asarray(img).astype(np.int32)
        names = sorted(os.listdir(os.path.join(domains, src)))[:2]
        inputs = select_checkpoints.load_batch(os.path.join(domains, src),
                                               names)
        truths = select_checkpoints.load_batch(os.path.join(domains, truth),
                                               names)
        # JPEG at quality 92: the input and truth panels within a few levels
        assert np.abs(grid[:256, :256] - inputs[0]).mean() < 3
        assert np.abs(grid[256:, 512:] - truths[1]).mean() < 3


# ---------------------------------------------------------------------------
# reproduce_quality_study
# ---------------------------------------------------------------------------

def test_synthetic_smoke_matches_jax(on_cpu, monkeypatch, tmp_path, capsys):
    """JAX's smoke, its random generators recorded; the port's smoke on
    those generators (``state_dict_from_jax_params``): the same images,
    averages within the metric limits, the same wins and verdict."""
    import multi_style_transfer_gan_tpu.models as jax_models

    made = {}
    for name, kind in (("plain_generator_init", "plain"),
                       ("enhanced_generator_init", "enhanced")):
        real = getattr(jax_models, name)
        monkeypatch.setattr(jax_models, name, lambda *a, _r=real, _k=kind,
                            **kw: made.setdefault(_k, _r(*a, **kw)))
    want = jax_rqs.synthetic_smoke(str(tmp_path / "jax"))
    monkeypatch.setattr(reproduce_quality_study, "random_models", lambda: (
        state_dict_from_jax_params(made["plain"], "plain"),
        state_dict_from_jax_params(made["enhanced"])))
    got = reproduce_quality_study.synthetic_smoke(str(tmp_path / "port"))
    assert got["n_images"] == want["n_images"] == 6
    for model in ("cyclegan", "localstyle"):
        for metric, tol in STUDY_TOL.items():
            if (model, metric) == ("localstyle", "mse"):
                tol = dict(rtol=LOCAL_STYLE_MSE_RTOL, atol=0)
            np.testing.assert_allclose(got[model][metric],
                                       want[model][metric], **tol,
                                       err_msg=f"{model} {metric}")
    assert got["wins"] == want["wins"] and got["verdict"] == want["verdict"]
    assert os.path.exists(got["xlsx"])
    out = capsys.readouterr().out
    assert "=== computed vs published (n=6 vs 54 images) ===" in out


def test_random_models_follow_the_seeded_init():
    """The smoke's generators: a plain c8 and an enhanced c4, the same
    tensors on every call (seeded ``torch.Generator``s, not the global
    one)."""
    torch.manual_seed(123)
    plain, enhanced = reproduce_quality_study.random_models()
    torch.manual_seed(456)
    plain2, enhanced2 = reproduce_quality_study.random_models()
    assert plain["encoder.0.weight"].shape == (8, 3, 4, 4)
    assert enhanced["initial.0.weight"].shape == (4, 3, 7, 7)
    for a, b in ((plain, plain2), (enhanced, enhanced2)):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_quality_study_real_mode(on_cpu, domains, tmp_path, capsys):
    """The real mode on the synthetic domains with the trained pair staged
    in the reference layout; the missing-checkpoint exit."""
    models = tmp_path / "models"
    models.mkdir()
    torch.save({f"G_{k}_state_dict": _trained_sd(k) for k in ("AB", "BA")},
               models / "cyclegan_epoch_200.pth")
    argv = ["--data_root", domains, "--models_dir", str(models),
            "--output_dir", str(tmp_path / "study"), "--max_images", "3",
            "--batch_size", "4"]
    with pytest.raises(SystemExit, match="missing checkpoint: .*"
                                         "G_BA_epoch_200.pth"):
        reproduce_quality_study.main(argv)
    shutil.copy(os.path.join(TRAINED, "G_BA_selected.pth"),
                models / "G_BA_epoch_200.pth")
    assert reproduce_quality_study.main(argv) == 0
    out = capsys.readouterr().out
    assert "=== computed vs published (n=3 vs 54 images) ===" in out
    assert "verdict: " in out
    assert sorted(os.listdir(tmp_path / "study" / "originals")) == sorted(
        os.listdir(os.path.join(domains, "testB")))[:3]
    for sub in ("cyclegan_photo2monet", "local_style_enhanced_photo2monet"):
        assert len(os.listdir(tmp_path / "study" / "outputs" / sub)) == 3
    assert os.path.exists(tmp_path / "study"
                          / "detailed_metrics_comparison.xlsx")


# ---------------------------------------------------------------------------
# run_trained_surface: staging and the conversion round trip
# ---------------------------------------------------------------------------

def test_surface_stage_models_and_convert_roundtrip(on_cpu, tmp_path):
    models = tmp_path / "models"
    _stage_epochs(str(models), (7,), seed=7)
    got = run_trained_surface.stage_models(str(models), 7,
                                           str(tmp_path / "port"))
    want = jax_rts.stage_models(str(models), 7, str(tmp_path / "jax"))
    names = ["G_AB_epoch_200.pth", "G_BA_epoch_200.pth",
             "cyclegan_epoch_200.pth"]
    assert sorted(os.listdir(got)) == sorted(os.listdir(want)) == sorted(names)
    for n in names[:2]:
        assert (open(os.path.join(got, n), "rb").read()
                == open(os.path.join(want, n), "rb").read())
    dual, jax_dual = (torch.load(os.path.join(d, names[2]), map_location="cpu",
                                 weights_only=False) for d in (got, want))
    assert list(dual) == list(jax_dual) == ["epoch", "G_AB_state_dict",
                                            "G_BA_state_dict"]
    assert dual["epoch"] == 7
    for key in ("G_AB_state_dict", "G_BA_state_dict"):
        for k, v in jax_dual[key].items():
            assert torch.equal(dual[key][k], v)

    out = tmp_path / "out"
    out.mkdir()
    assert run_trained_surface.convert_roundtrip(got, str(out)) == {
        "max_delta": 0.0}
    from multi_style_transfer_gan_tpu.cli import convert_model as jax_convert

    jax_convert.main(["--input", os.path.join(got, "G_BA_epoch_200.pth"),
                      "--output", str(tmp_path / "jax_converted.pth")])
    ours = load_pth(str(out / "converted_G_BA.pth"))
    theirs = torch.load(str(tmp_path / "jax_converted.pth"),
                        map_location="cpu", weights_only=False)
    assert list(ours) == list(theirs)
    assert all(torch.equal(torch.as_tensor(ours[k]), torch.as_tensor(v))
               for k, v in theirs.items())


# ---------------------------------------------------------------------------
# the figures on a host without matplotlib (the card's machine)
# ---------------------------------------------------------------------------

def test_surface_figures_without_matplotlib(monkeypatch, tmp_path):
    """Where matplotlib does not import, the surface's figures (the
    comparison bar charts, m_test's panels, the compare tab's side by side,
    the advanced grid, the local-style 4-panel figure) are drawn with PIL
    at the same paths."""
    from multi_style_transfer_gan_tpu_torch.metrics import fid_harness, report
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        advanced, local_style,
    )
    from multi_style_transfer_gan_tpu_torch.utils import figures

    monkeypatch.setattr(figures, "have_matplotlib", lambda: False)
    rng = np.random.default_rng(5)
    u8 = lambda h, w: rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    report.comparison_bar_chart(str(tmp_path / "bars.png"), ["a", "b"],
                                {"x": [1.0, 2.0], "y": [0.5, 3.0]}, "t", "v")
    fid_harness._save_panels(np.stack([u8(32, 32)] * 3),
                             torch.rand(3, 32, 32, 3), "photo2monet",
                             str(tmp_path))
    paths = {}
    for name in ("standard", "contrast"):
        paths[name] = str(tmp_path / f"{name}.jpg")
        Image.fromarray(u8(40, 30)).save(paths[name])
    advanced._comparison_grid(u8(40, 30), paths, str(tmp_path), "enhanced")
    local_style._comparison(u8(24, 24), u8(24, 24), rng.random((24, 24)),
                            Image.fromarray(u8(24, 24)),
                            str(tmp_path / "comparison.jpg"))
    sizes = {"bars.png": (720, 480), "panels_photo2monet.png": (144, 124),
             "enhanced_comparison.jpg": (138, 70),
             "comparison.jpg": (80, 108)}
    for name, size in sizes.items():
        with Image.open(tmp_path / name) as img:
            assert img.size == size, name


# ---------------------------------------------------------------------------
# the menus, through a stub python
# ---------------------------------------------------------------------------

MENU_DIR = os.path.join(REPO, "multi_style_transfer_gan_tpu_torch", "scripts")


def _menu_argv(tmp_path, script, answers):
    """Run a menu with ``answers`` on its stdin and a ``python`` on PATH
    that records its working directory and argv; returns them (None when
    the menu ran nothing)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp_path / "argv.json"
    if log.exists():
        log.unlink()
    stub = bin_dir / "python"
    stub.write_text(f"#!{sys.executable}\n"
                    "import json, os, sys\n"
                    f"json.dump([os.getcwd()] + sys.argv[1:], "
                    f"open({str(log)!r}, 'w'))\n")
    stub.chmod(0o755)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"}
    proc = subprocess.run(["bash", script], input="\n".join(answers) + "\n",
                          env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    return json.loads(log.read_text()) if log.exists() else None


def _both_menus(tmp_path, name, answers):
    got = _menu_argv(tmp_path, os.path.join(MENU_DIR, name), answers)
    want = _menu_argv(tmp_path, os.path.join(REPO, "scripts", name), answers)
    if want is not None:
        assert want[:3] == [REPO, "-m", "multi_style_transfer_gan_tpu.cli."
                                        "batch_process_images"]
        want[2] = "multi_style_transfer_gan_tpu_torch.cli.batch_process_images"
    return got, want


@pytest.mark.parametrize("choice", [str(c) for c in range(1, 10)])
def test_batch_menu_runs_the_jax_menus_argv(tmp_path, choice):
    got, want = _both_menus(tmp_path, "batch_process.sh",
                            [choice, "in_dir", ""])
    assert got == want
    assert (got is None) == (choice == "9")


@pytest.mark.parametrize("answers", [
    [""] * 9,
    ["photos", "out", "cyclegan", "monet2photo", "advanced", "0.5", "0.3",
     "n", "n"],
    ["", "", "", "", "simple", "", "", "y", "no"],
    ["", "", "", "", "", "", "", "nope", "yes"],
])
def test_advanced_menu_runs_the_jax_menus_argv(tmp_path, answers):
    got, want = _both_menus(tmp_path, "advanced_batch_process.sh", answers)
    assert got == want and got is not None


# ---------------------------------------------------------------------------
# without a card; on the card
# ---------------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _flags(main, monkeypatch):
    """Each option of ``main``'s parser: (flags, default, type, required,
    action class), read where it parses its argv."""
    import argparse

    seen = []

    def parse_args(self, args=None, namespace=None):
        seen.extend(sorted(
            (tuple(a.option_strings), repr(a.default), getattr(a.type,
                                                                "__name__",
                                                                None),
             a.required, type(a).__name__)
            for a in self._actions if a.option_strings))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("name", ["make_synthetic_domains",
                                  "select_checkpoints", "make_sample_grids",
                                  "reproduce_quality_study",
                                  "run_trained_surface"])
def test_scripts_take_the_jax_scripts_flags(monkeypatch, name):
    import importlib

    import make_sample_grids as jax_msg  # noqa: F401 (scripts/ on the path)

    port = importlib.import_module(
        f"multi_style_transfer_gan_tpu_torch.scripts.{name}")
    jax_script = importlib.import_module(name)
    got = _flags(port.main, monkeypatch)
    assert got and got == _flags(jax_script.main, monkeypatch)


@pytest.mark.parametrize("script,argv", [
    (select_checkpoints, ["--models_dir", "m", "--data_root", "d",
                          "--selected_dir", "s"]),
    (make_sample_grids, ["--selected_dir", "s", "--data_root", "d",
                         "--output_dir", "o"]),
    (reproduce_quality_study, ["--synthetic"]),
    (run_trained_surface, ["--models_dir", "m", "--epoch", "1",
                           "--data_root", "d", "--output_dir", "o"]),
])
def test_scripts_exit_1_without_cuda(monkeypatch, capsys, script, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert script.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest tests/ -m gpu` "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_forward_u8_on_the_card_matches_cpu(cuda, domains):
    """The trained pair's fp32 forward_u8 on the last 4 testB / testA
    images, card vs CPU (TF32 off), at the program's limit."""
    for key in ("BA", "AB"):
        inputs, _ = select_checkpoints.make_eval(key, domains, 4)
        path = os.path.join(TRAINED, f"G_{key}_selected.pth")
        got, want = (select_checkpoints.forward_u8(
            load_generator(path, device=dev), inputs,
            compute_dtype=torch.float32) for dev in (cuda, "cpu"))
        d = _levels(got, want)
        assert d.max() <= PROGRAM_MAX and (d > 0).mean() <= PROGRAM_SHARE


@pytest.mark.gpu
def test_soup_export_on_the_card_is_bit_equal(cuda, monkeypatch, domains,
                                              tmp_path):
    """select_checkpoints.main on the card: the exported G_*_epoch_0.pth
    hold the host soup of the window it reports (or the picked epoch's
    tensors), bit for bit."""
    models = str(tmp_path / "models")
    _stage_epochs(models, (1, 2, 3), seed=11)
    sel = tmp_path / "selected"
    assert select_checkpoints.main(
        ["--models_dir", models, "--data_root", domains,
         "--selected_dir", str(sel), "--n_val", "4", "--soup_max", "3"]) == 0
    report = json.loads((sel / "selection_report.json").read_text())
    for key, rec in report["per_direction"].items():
        name = f"G_{key}_state_dict"
        paths = [os.path.join(models, f"G_{key}_epoch_{e}.pth")
                 for e in rec["soup"]["epochs"]]
        want = (select_checkpoints.soup_state_dict(paths, name)
                if rec["selected"] == "soup" else load_pth(paths[-1])[name])
        got = load_pth(str(sel / f"G_{key}_epoch_0.pth"))[name]
        assert list(got) == list(want)
        assert all(torch.equal(got[k], v) for k, v in want.items())
