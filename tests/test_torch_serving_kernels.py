"""The two serving kernels on tensor cores: what can be held on the CPU, and
kernel vs plain on the card.

On the CPU: the rounding emulation of the bf16 warp-MMA chains
(``devtools/serving_kernel_rounding.py``) stays inside ``chip_smoke.py``'s
bf16 bound with the hi + lo operand pairs the kernels use and leaves it
without them (which is what justifies the pairs); the stress inputs go
through the JAX math and the port's plain version alike; the persistent
grid's size rule and the shared-memory layouts mirrored in Python; the
native library's build lands atomically; the port's "not ported" messages
name the work. Tests marked ``gpu`` build the CUDA kernels and hold them
against the plain versions on the stress inputs at every serving shape;
they skip without a CUDA device.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as smoke
from devtools import serving_kernel_rounding as rounding
from multi_style_transfer_gan_tpu.models.enhanced_generator import (
    _attention_math,
)
from multi_style_transfer_gan_tpu_torch import native
from multi_style_transfer_gan_tpu_torch.ops import kernels as K
from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
    block_launch_shape,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention import (
    attention_launch_shape, persistent_grid,
)
from multi_style_transfer_gan_tpu_torch.pipelines import (
    load_generator, make_batch_fn,
)

TRAINED = smoke.TRAINED
LABELS = ("random", "saturated", "small q, k")
SERVING_SHAPES = {s[-1]: s for _, s in smoke.attention_shapes(256)}
BLOCK_TEST_SHAPES = ((2, 16, 16, 64), (2, 12, 20, 64))


# ---------------------------------------------------------------------------
# rounding emulation (CPU)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _attention_ratios():
    torch.set_num_threads(2)
    return rounding.attention_ratios()


@functools.lru_cache(maxsize=None)
def _block_ratios():
    return rounding.block_ratios(shapes=BLOCK_TEST_SHAPES)


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("C", [16, 32, 64])
def test_attention_emulation_holds_the_bf16_bound(C, label):
    """qn and kn as hi + lo pairs, v, the softmax and its output as one
    term: inside BF16_ATOL, BF16_RTOL of the plain version at the canvas-256
    shape of width C on every stress input."""
    d, ratio = _attention_ratios()[(SERVING_SHAPES[C], label, "kernel")]
    assert np.isfinite(d) and ratio < 1.0


@pytest.mark.parametrize("C", [16, 32, 64])
def test_attention_emulation_needs_the_qk_pairs(C):
    """With one bf16 term for qn and kn the saturated input leaves the
    bound at every width, and the pairs bring it back with room to spare."""
    ratios = _attention_ratios()
    shape = SERVING_SHAPES[C]
    assert ratios[(shape, "saturated", "all one term")][1] > 1.0
    assert ratios[(shape, "saturated", "kernel")][1] < 0.8


@pytest.mark.parametrize("label", ["random", "saturated"])
@pytest.mark.parametrize("shape", BLOCK_TEST_SHAPES)
def test_block_emulation_holds_the_bf16_bound(shape, label):
    d, ratio = _block_ratios()[(shape, label, "kernel")]
    assert np.isfinite(d) and ratio < 1.0


@pytest.mark.parametrize("plan", ["all one term", "h split", "q, k split"])
def test_block_emulation_needs_both_pairs(plan):
    """On 16-fold scores neither pair alone holds the bound: LN1's output
    (for q and k) and q, k themselves both have to be hi + lo."""
    ratios = _block_ratios()
    for shape in BLOCK_TEST_SHAPES:
        assert ratios[(shape, "saturated", plan)][1] > 1.0
        assert ratios[(shape, "random", plan)][1] < 1.0


def test_emulation_with_every_operand_split_is_the_plain_version(rng):
    """The emulation's own arithmetic: with every operand as a pair it
    agrees with the plain versions to ~2^-16."""
    shape = (2, 8, 8, 32)
    _, x, ws = smoke.attention_stress_inputs(rng, shape, packed=True)[1]
    t = torch.from_numpy(x).to(torch.bfloat16).reshape(-1, 16, 32)
    ws = [torch.from_numpy(np.asarray(w, np.float32)).to(torch.bfloat16)
          for w in ws]
    plan = dict(qk=True, v=True, S=True, out=True)
    got = rounding.attention_chain(t.float(), *ws, plan)
    ref = K.window_attention.window_rows_attention_plain(t, *ws)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=1e-4)


# ---------------------------------------------------------------------------
# stress inputs (CPU): layouts, and the JAX math on them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [16, 64])
def test_attention_stress_inputs_layouts(rng, C):
    shape = (2, 8, 12, C)
    nhwc = smoke.attention_stress_inputs(np.random.default_rng(5), shape)
    packed = smoke.attention_stress_inputs(np.random.default_rng(5), shape,
                                           packed=True)
    assert [c[0] for c in nhwc] == list(LABELS)
    for (_, x, ws), (_, xp, wsp) in zip(nhwc, packed):
        assert x.shape == shape and xp.shape == (2, 2, 3, 16 * C)
        assert not x[0, :4, :4].any() and not xp[0, 0, 0].any()
        np.testing.assert_array_equal(
            K.space_to_depth_plain(torch.from_numpy(x), 4).numpy(), xp)
        for a, b in zip(ws, wsp):
            np.testing.assert_array_equal(a, b)
    flat = nhwc[1][1][1, 4:8, 8:12]
    assert (flat == flat[:1, :1]).all()        # constant inside a window
    assert not nhwc[2][2][1][:2 * C].any()     # no q, k bias
    assert np.abs(nhwc[2][1][0, 4:8, :4]).max() < 1e-2


@pytest.mark.parametrize("label", LABELS)
def test_attention_plain_matches_jax_math_on_stress_inputs(label):
    """The same stress input through the JAX package's attention math and
    the port's plain version (fp32)."""
    cases = smoke.attention_stress_inputs(np.random.default_rng(7),
                                          (2, 8, 12, 32))
    _, x, (wq, bq, wp, bp) = next(c for c in cases if c[0] == label)
    f = lambda a: np.asarray(a, np.float32)
    ref = np.asarray(_attention_math(
        jnp.asarray(f(x)), jnp.asarray(f(wq).T[None, None]), jnp.asarray(f(bq)),
        jnp.asarray(f(wp).T[None, None]), jnp.asarray(f(bp)), window_size=4,
        eps=1e-12))
    got = K.window_channel_attention(*(torch.from_numpy(f(a))
                                       for a in (x, wq, bq, wp, bp))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)


def test_block_stress_inputs(rng):
    (_, host, w), (label, host2, sharp) = smoke.block_stress_inputs(
        rng, (2, 12, 20, 64))
    assert label == "saturated" and host2 is host
    assert not host[0][0, :8, :8].any() and not host[1][0, :8, :8].any()
    np.testing.assert_array_equal(sharp["qkv_w"][:128], 4.0 * w["qkv_w"][:128])
    np.testing.assert_array_equal(sharp["qkv_w"][128:], w["qkv_w"][128:])


# ---------------------------------------------------------------------------
# the persistent grid and the layouts mirrored in Python (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("units,sms,per_sm,grid", [
    (0, 132, 1, 1),          # nothing to do still launches one block
    (1, 132, 3, 1),          # fewer units than blocks: one block a unit
    (131, 132, 1, 131),
    (132, 132, 1, 132),
    (133, 132, 1, 132),      # one more unit than blocks: blocks stride
    (4096, 132, 6, 792),
])
def test_persistent_grid(units, sms, per_sm, grid):
    assert persistent_grid(units, sms, per_sm) == grid


@pytest.mark.parametrize("n_windows,C,bf16,units,smem", [
    (2048, 64, True, 256, 146432),    # one window a warp, 8 warps
    (2049, 64, True, 257, 146432),    # n_windows not a multiple of the tile
    (7, 16, True, 1, 36608),
    (32768, 16, False, 8192, 25984),  # fp32: tiles of 64 / C windows
    (5, 32, False, 3, 42368),
])
def test_attention_launch_shape(n_windows, C, bf16, units, smem):
    assert attention_launch_shape(n_windows, C, bf16) == (units, smem)
    assert smem <= 227 * 1024


@pytest.mark.parametrize("grid_shape,units", [
    ((8, 64, 64), 256), ((2, 12, 20), 6), ((1, 8, 8), 1), ((3, 8, 8), 2)])
def test_block_launch_shape(grid_shape, units):
    got_units, smem = block_launch_shape(*grid_shape)
    assert got_units == units and smem == 209152 <= 227 * 1024


# ---------------------------------------------------------------------------
# the native library's build, and the messages of what is not ported (CPU)
# ---------------------------------------------------------------------------

def test_native_build_moves_the_library_into_place(tmp_path, monkeypatch):
    """The build runs in a scratch copy and the finished file is renamed
    into place: while make runs, the final path does not exist."""
    so = tmp_path / "libmstgan_native.so"
    (tmp_path / "mstgan_native.cpp").write_text("// stand-in\n")
    (tmp_path / "Makefile").write_text(
        "libmstgan_native.so: mstgan_native.cpp\n"
        "\ttest ! -e ../libmstgan_native.so\n"
        "\tprintf half > $@\n\tprintf whole > $@\n")
    monkeypatch.setattr(native, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO_PATH", str(so))
    assert native._build() is True
    assert so.read_text() == "whole"
    assert sorted(os.listdir(tmp_path)) == ["Makefile", "libmstgan_native.so",
                                            "mstgan_native.cpp"]
    # a failing build leaves what was there alone and reports it
    (tmp_path / "Makefile").write_text(
        "libmstgan_native.so: mstgan_native.cpp\n\tfalse\n")
    so.unlink()
    assert native._build() is False and not so.exists()


@pytest.mark.parametrize("call", ["loader int8", "loader plain",
                                  "program int8", "program post chain"])
def test_not_ported_messages_name_the_work(call, tmp_path):
    calib = [np.zeros((1, 32, 32, 3), np.float32)]
    if call == "loader int8":
        # ported since: the int8 engine loads and runs, so there is no
        # message left to check
        model = load_generator(TRAINED, precision="int8",
                               calib_batches=calib, device="cpu")
        out = model.apply(torch.zeros(1, 32, 32, 3))
        assert model.precision == "int8" and out.shape == (1, 32, 32, 3)
        assert out.dtype == torch.bfloat16
        return
    elif call == "loader plain":
        from torch_oracle import make_plain_sd

        path = tmp_path / "plain.pth"
        torch.save({"G_AB_state_dict": make_plain_sd(
            np.random.default_rng(0), c=8)}, path)
        # ported since: the plain generator loads and runs, so there is no
        # message left to check
        model = load_generator(path, device="cpu")
        out = model.apply(torch.zeros(1, 32, 32, 3))
        assert model.kind == "plain" and out.shape == (1, 32, 32, 3)
        return
    else:
        model = load_generator(TRAINED, device="cpu")
        kw = (dict(engine="int8", calib_batches=calib)
              if call == "program int8"
              else dict(local_style_mode="advanced"))
        mode = "cyclegan" if call == "program int8" else "local_style"
        fn = lambda: make_batch_fn(model, mode, device="cpu", **kw)
        words = "int8 engine"
        if call in ("program post chain", "program int8"):
            # ported since: the program with the advanced chain, and the
            # int8 program, build and run, so there is no message left to
            # check
            out = fn()(np.zeros((1, 32, 32, 3), np.uint8))
            assert out.shape == (1, 32, 32, 3) and out.dtype == torch.uint8
            return
    with pytest.raises(NotImplementedError) as err:
        fn()
    message = str(err.value)
    assert words in message and "ROADMAP.md" in message
    assert not re.search(r"item \d", message)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest tests/ -m gpu` "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check(got, ref, dtype, fp32_tol):
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=fp32_tol, rtol=fp32_tol)
    else:
        torch.testing.assert_close(got.float(), ref.float(),
                                   atol=smoke.BF16_ATOL, rtol=smoke.BF16_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", ["down1", "down2", "up2"])
@pytest.mark.parametrize("canvas", [256, 512])
def test_attention_kernels_on_stress_inputs(cuda, canvas, stage, dtype):
    """NHWC and packed kernels vs plain at a serving shape on the three
    stress inputs; the packed kernel's result is the NHWC kernel's, one
    relayout away."""
    shape = dict(smoke.attention_shapes(canvas))[stage]
    for (label, x, ws), (_, xp, _) in zip(
            smoke.attention_stress_inputs(np.random.default_rng(11), shape),
            smoke.attention_stress_inputs(np.random.default_rng(11), shape,
                                          packed=True)):
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda,
                                                                     dtype)
        ws = [t(w) for w in ws]
        got = K.window_channel_attention(t(x), *ws)
        got_p = K.packed_window_channel_attention(t(xp), *ws)
        torch.cuda.synchronize()
        _check(got, K.window_channel_attention_plain(t(x), *ws), dtype, 1e-4)
        _check(got_p, K.packed_window_channel_attention_plain(t(xp), *ws),
               dtype, 1e-4)
        assert torch.equal(K.space_to_depth_plain(got, 4), got_p), label


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_full_stage_is_the_production_kernel_on_stress_inputs(cuda, C, dtype):
    for label, x, ws in smoke.attention_stress_inputs(
            np.random.default_rng(13), (2, 16, 24, C)):
        args = [torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dtype)
                for a in [x] + ws]
        full = K.window_channel_attention_stage(*args, stage="full")
        assert torch.equal(full, K.window_channel_attention(*args)), label
        for stage in K.STAGES[:-1]:
            got = K.window_channel_attention_stage(*args, stage=stage)
            ref = K.window_channel_attention_stage_plain(*args, stage=stage)
            _check(got, ref, dtype, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 64, 64), (8, 128, 128, 64),
                                   (2, 12, 20, 64), (1, 5, 3, 64)])
def test_block_kernel_on_stress_inputs(cuda, shape, dtype):
    for label, host, weights in smoke.block_stress_inputs(
            np.random.default_rng(17), shape):
        t = lambda a, dt=dtype: torch.from_numpy(
            np.asarray(a, np.float32)).to(cuda, dt)
        args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                t(host[3], torch.float32))
        kw = {n: t(a) for n, a in weights.items()}
        got = K.fused_structural_block(*args, **kw)
        torch.cuda.synchronize()
        _check(got, K.structural_block_plain(*args, **kw), dtype, 2e-4)


@pytest.mark.gpu
def test_kernels_give_the_same_bits_every_launch(cuda):
    """No race between the warps of a block: 20 launches of each kernel on
    one input agree bit for bit, in fp32 and bf16."""
    rng = np.random.default_rng(19)
    for dtype in (torch.float32, torch.bfloat16):
        t = lambda a, dt=dtype: torch.from_numpy(
            np.asarray(a, np.float32)).to(cuda, dt)
        _, x, ws = smoke.attention_stress_inputs(rng, (4, 64, 64, 64))[0]
        args = [t(a) for a in [x] + ws]
        first = K.window_channel_attention(*args)
        _, host, weights = smoke.block_stress_inputs(rng, (4, 36, 28, 64))[0]
        b_args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                  t(host[3], torch.float32))
        kw = {n: t(a) for n, a in weights.items()}
        b_first = K.fused_structural_block(*b_args, **kw)
        for _ in range(19):
            assert torch.equal(K.window_channel_attention(*args), first)
            assert torch.equal(K.fused_structural_block(*b_args, **kw), b_first)
