"""The stage ablation of the channel-attention kernel (TPU row 13,
``scripts/ab_v3_ablation.py::run_stage``) against the port's stage
instrument.

On the CPU each stage's plain version is held against ``run_stage`` with its
``pallas_call`` in interpret mode (and, where that does not build, against
a numpy version of the stated fold); the wrapper's checks and the tool's
exit without a card are tested too. Tests marked ``gpu`` hold each stage
kernel against its plain version and ``full`` against the production
kernel; they skip without a CUDA device.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_style_transfer_gan_tpu_torch.ops.kernels import (
    STAGES, reset_launch_counts, window_channel_attention,
    window_channel_attention_plain, window_channel_attention_stage,
    window_channel_attention_stage_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def _ab_v3():
    path = os.path.join(REPO, "scripts", "ab_v3_ablation.py")
    spec = importlib.util.spec_from_file_location("ab_v3_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def run_stage(monkeypatch):
    """``run_stage`` of the TPU ablation, its pallas_call in interpret
    mode."""
    mod = _ab_v3()
    orig = mod.pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(mod.pl, "pallas_call", interp)
    return mod.run_stage


def _case(rng, C, shape=(2, 16, 16)):
    """fp32 NHWC x with one all-zero window, and (out, in) weights."""
    x = rng.standard_normal(shape + (C,)).astype(np.float32)
    x[0, :4, :4] = 0.0
    return (x, (rng.standard_normal((3 * C, C)) * 0.3).astype(np.float32),
            rng.standard_normal(3 * C).astype(np.float32),
            (rng.standard_normal((C, C)) * 0.3).astype(np.float32),
            rng.standard_normal(C).astype(np.float32))


def _jax_stage(run_stage, stage, x, wq, bq, wp, bp):
    """The TPU harness on the same inputs: 1x1 HWIO kernels, 32-row tiles."""
    out = run_stage(jnp.asarray(x), jnp.asarray(wq.T[None, None]),
                    jnp.asarray(bq), jnp.asarray(wp.T[None, None]),
                    jnp.asarray(bp), stage=stage, tile_rows=32)
    return np.asarray(out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _numpy_fold(stage, x, wq, bq, wp, bp, eps=1e-12):
    """The logits / softmax fold of the stated definition in float64 numpy:
    v + (p < min(C, 16) ? sum_c2 G[p, c2] : 0) per window."""
    B, H, W, C = x.shape
    t = x.reshape(B, H // 4, 4, W // 4, 4, C).transpose(0, 1, 3, 2, 4, 5)
    t = t.reshape(-1, 16, C).astype(np.float64)
    qkv = t @ wq.T.astype(np.float64) + bq
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]

    def norm(u):
        n = np.sqrt((u * u).sum(-1, keepdims=True))
        return u / np.maximum(n, eps)

    g = norm(q).transpose(0, 2, 1) @ norm(k)
    if stage == "softmax":
        e = np.exp(g - g.max(-1, keepdims=True))
        g = e / e.sum(-1, keepdims=True)
    n = min(C, 16)
    fold = np.zeros(t.shape[:2])
    fold[:, :n] = g.sum(-1)[:, :n]
    out = (v + fold[..., None]).reshape(B, H // 4, W // 4, 4, 4, C)
    return out.transpose(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


# ---------------------------------------------------------------------------
# the plain stages vs the TPU harness, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", STAGES)
def test_stage_plain_matches_jax_run_stage(rng, run_stage, stage):
    """C = 16: every stage is what the TPU ablation computes."""
    args = _case(rng, 16)
    ref = _jax_stage(run_stage, stage, *args)
    got = window_channel_attention_stage_plain(*map(_t, args), stage=stage)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("stage", ["copy", "qkv", "norm", "full"])
def test_stage_plain_matches_jax_run_stage_at_c32(rng, run_stage, stage):
    """C = 32: the stages whose TPU fold builds there."""
    args = _case(rng, 32)
    ref = _jax_stage(run_stage, stage, *args)
    got = window_channel_attention_stage_plain(*map(_t, args), stage=stage)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("stage", ["logits", "softmax"])
def test_fold_stages_match_the_stated_fold(rng, stage, C):
    """C > 16, where the TPU fold does not build: the same rule in numpy."""
    args = _case(rng, C)
    ref = _numpy_fold(stage, *args)
    got = window_channel_attention_stage_plain(*map(_t, args), stage=stage)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("C", [16, 32, 64])
def test_full_stage_is_the_op(rng, C):
    args = [_t(a) for a in _case(rng, C, (1, 8, 12))]
    torch.testing.assert_close(
        window_channel_attention_stage_plain(*args, stage="full"),
        window_channel_attention_plain(*args), atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_stages(rng):
    reset_launch_counts()
    args = [_t(a) for a in _case(rng, 32, (1, 8, 8))]
    for stage in STAGES:
        torch.testing.assert_close(
            window_channel_attention_stage(*args, stage=stage),
            window_channel_attention_stage_plain(*args, stage=stage),
            atol=0, rtol=0)
    assert window_channel_attention_stage.launches == 0


def test_stage_wrapper_raises_on_what_it_does_not_take(rng):
    args = [_t(a) for a in _case(rng, 16, (1, 8, 8))]
    with pytest.raises(ValueError, match="stage must be one of"):
        window_channel_attention_stage(*args, stage="proj")
    args24 = [_t(a) for a in _case(rng, 24, (1, 8, 8))]
    with pytest.raises(ValueError, match="built for C"):
        window_channel_attention_stage(*args24, stage="copy")
    ragged = [_t(a) for a in _case(rng, 16, (1, 8, 10))]
    with pytest.raises(ValueError, match="divisible by 4"):
        window_channel_attention_stage(*ragged, stage="full")


def test_ablation_tool_exits_nonzero_without_cuda(monkeypatch, capsys):
    from multi_style_transfer_gan_tpu_torch.tools.attention_ablation import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--batch", "1", "--hw", "8"]) == 1
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err
    assert captured.out == ""


def test_ablation_inputs_follow_the_jax_script(monkeypatch):
    """The weights are the JAX script's draws order and scales, laid out
    (out, in); x has the requested shape; all are bf16, as the JAX
    script fixes it."""
    from multi_style_transfer_gan_tpu_torch.tools.attention_ablation import (
        ablation_inputs,
    )

    x, (wq, bq, wp, bp) = ablation_inputs(2, 8, 16, torch.device("cpu"))
    rng = np.random.default_rng(0)
    want = [rng.standard_normal((1, 1, 16, 48)) * 0.1,
            rng.standard_normal(48) * 0.1,
            rng.standard_normal((1, 1, 16, 16)) * 0.1,
            rng.standard_normal(16) * 0.1]
    for got, ref in zip((wq, bq, wp, bp),
                        (want[0][0, 0].T, want[1], want[2][0, 0].T, want[3])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.float().numpy(),
            torch.from_numpy(np.ascontiguousarray(ref, np.float32))
            .to(torch.bfloat16).float().numpy())
    assert x.shape == (2, 8, 8, 16) and x.dtype == torch.bfloat16
    assert 0.3 < float(x.std()) < 0.7


# ---------------------------------------------------------------------------
# stage kernels vs plain on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest tests/ -m gpu` "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# bf16: both sides compute in fp32 from the same bf16 inputs and round once,
# so they may differ by one bf16 rounding of the output (2^-7 relative) plus
# fp32 summation order.
BF16_TOL = dict(atol=3e-2, rtol=2 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_stage_kernels_match_plain(rng, cuda, C, dtype):
    args = [_t(a).to(cuda, dtype) for a in _case(rng, C, (2, 16, 12))]
    for stage in STAGES:
        n0 = window_channel_attention_stage.launches
        got = window_channel_attention_stage(*args, stage=stage)
        torch.cuda.synchronize()
        assert window_channel_attention_stage.launches == n0 + 1
        ref = window_channel_attention_stage_plain(*args, stage=stage)
        assert torch.isfinite(got).all(), stage
        tol = dict(atol=1e-4, rtol=0) if dtype == torch.float32 else BF16_TOL
        torch.testing.assert_close(got.float(), ref.float(), **tol,
                                   msg=lambda m, s=stage: f"{s}: {m}")
        if stage == "full":
            assert torch.equal(got, window_channel_attention(*args))
