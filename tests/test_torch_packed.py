"""The port's packed (space-to-depth) engine vs the JAX package (CPU), and
its two kernels vs their plain versions on the card.

On the CPU the relayout and the packed attention run their plain versions;
every layer, the weight packing, the whole forward, the uint8 program and
the engine dispatch are held against the JAX functions on the same
numpy-seeded inputs. Tests marked ``gpu`` build the kernels and skip
without a CUDA device.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_style_transfer_gan_tpu.ops import packed as jpk
from multi_style_transfer_gan_tpu.models.packed_generator import (
    pack_enhanced_generator_params as jax_pack_params,
    packed_enhanced_generator_apply as jax_packed_apply,
)
from multi_style_transfer_gan_tpu.pipelines.batch import (
    make_batch_fn as jax_make_batch_fn, select_engine as jax_select_engine,
)
from multi_style_transfer_gan_tpu.pipelines.model_loader import (
    load_generator as jax_load_generator,
)
from multi_style_transfer_gan_tpu.weights.torch_import import (
    enhanced_generator_from_sd,
)
from multi_style_transfer_gan_tpu_torch.core.norm import instance_norm
from multi_style_transfer_gan_tpu_torch.models import (
    EnhancedGenerator, PackedEnhancedGenerator, pack_enhanced_generator_params,
    packed_enhanced_generator_apply,
)
from multi_style_transfer_gan_tpu_torch.ops import packed as tpk
from multi_style_transfer_gan_tpu_torch.ops.kernels import (
    depth_to_space_plain, fused_structural_block,
    packed_window_channel_attention, packed_window_channel_attention_plain,
    reset_launch_counts, space_to_depth_plain, window_channel_attention,
    window_channel_attention_plain, window_relayout,
)
from multi_style_transfer_gan_tpu_torch.pipelines import (
    batch_process, load_generator, make_batch_fn, select_engine,
)
from multi_style_transfer_gan_tpu_torch.weights import (
    state_dict_from_jax_params,
)

TRAINED = "trained/G_BA_selected.pth"
TRANSPOSED = ("up1.0", "up2.0")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# layout and weight repacking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f", [2, 4])
def test_space_to_depth_matches_jax_exactly(rng, f):
    x = rng.standard_normal((2, 16, 24, 5)).astype(np.float32)
    packed = window_relayout(_t(x), f)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpk.space_to_depth(x, f)))
    back = window_relayout(packed, f, inverse=True)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        tpk.depth_to_space(_t(np.asarray(jpk.space_to_depth(x, f))), f).numpy(),
        np.asarray(jpk.depth_to_space(jpk.space_to_depth(x, f), f)))


# (K, stride, pad, dilation, f_in, f_out)
CONV_CASES = [
    (7, 1, 3, 1, 4, 4),   # stem and output conv
    (4, 2, 1, 1, 4, 4),   # down1/down2
    (3, 1, 1, 1, 4, 4),   # MSB branch2
    (3, 1, 2, 2, 4, 4),   # MSB branch3 (dilated)
    (3, 1, 4, 4, 4, 4),   # MSB branch4 (dilated)
    (3, 2, 1, 1, 4, 4),   # struct-embed convs
    (3, 2, 1, 1, 4, 2),   # mixed factors (needs the out_hw crop)
]


def _conv_weights(rng, K, Cin, Cout):
    return ((rng.standard_normal((Cout, Cin, K, K)) * 0.2).astype(np.float32),
            rng.standard_normal(Cout).astype(np.float32))


@pytest.mark.parametrize("K,stride,pad,dil,f_in,f_out", CONV_CASES)
def test_pack_conv2d_weight_matches_jax_exactly(rng, K, stride, pad, dil,
                                                f_in, f_out):
    w, b = _conv_weights(rng, K, 3, 5)
    kw = dict(f_in=f_in, f_out=f_out, stride=stride, padding=pad,
              dilation=dil)
    w_p, b_p, spec = tpk.pack_conv2d_weight(_t(w), _t(b), **kw)
    jw, jb, jspec = jpk.pack_conv2d_weight(jnp.asarray(w.transpose(2, 3, 1, 0)),
                                           jnp.asarray(b), **kw)
    np.testing.assert_array_equal(w_p.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jw))
    np.testing.assert_array_equal(b_p.numpy(), np.asarray(jb))
    assert spec["stride"] == tuple(jspec["stride"])
    assert spec["padding"] == tuple(p[0] for p in jspec["padding"])
    assert spec == tpk.pack_conv2d_spec(K, **kw)


@pytest.mark.parametrize("f_in,f_out", [(4, 4), (2, 2)])
def test_pack_conv_transpose2d_weight_matches_jax_exactly(rng, f_in, f_out):
    w = (rng.standard_normal((6, 5, 4, 4)) * 0.2).astype(np.float32)  # IOHW
    b = rng.standard_normal(5).astype(np.float32)
    kw = dict(f_in=f_in, f_out=f_out, stride=2, padding=1)
    w_p, b_p, spec = tpk.pack_conv_transpose2d_weight(_t(w), _t(b), **kw)
    jw, jb, jspec = jpk.pack_conv_transpose2d_weight(
        jnp.asarray(w.transpose(2, 3, 0, 1)), jnp.asarray(b), **kw)
    # JAX: HWIO of a torch-semantics transposed conv; port: IOHW, no flip
    np.testing.assert_array_equal(w_p.permute(2, 3, 0, 1).numpy(),
                                  np.asarray(jw))
    np.testing.assert_array_equal(b_p.numpy(), np.asarray(jb))
    assert spec == {k: tuple(v) for k, v in jspec.items()}
    assert spec == tpk.pack_conv_transpose2d_spec(4, **kw)


@pytest.mark.parametrize("K,stride,pad,dil,f_in,f_out", CONV_CASES)
def test_packed_conv2d_matches_the_nhwc_conv(rng, K, stride, pad, dil, f_in,
                                             f_out):
    x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    w, b = _conv_weights(rng, K, 3, 5)
    ref = _nhwc(torch.nn.functional.conv2d(
        _nchw(_t(x)), _t(w), _t(b), stride=stride, padding=pad,
        dilation=dil))
    w_p, b_p, spec = tpk.pack_conv2d_weight(
        _t(w), _t(b), f_in=f_in, f_out=f_out, stride=stride, padding=pad,
        dilation=dil)
    out_hw = (ref.shape[1] // f_out, ref.shape[2] // f_out)
    got = tpk.packed_conv2d(tpk.space_to_depth(_t(x), f_in), w_p, b_p, spec,
                            out_hw=out_hw)
    got = tpk.depth_to_space(got, f_out)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_packed_conv_transpose2d_matches_the_nhwc_conv(rng):
    x = rng.standard_normal((2, 8, 12, 6)).astype(np.float32)
    w = (rng.standard_normal((6, 5, 4, 4)) * 0.2).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = _nhwc(torch.nn.functional.conv_transpose2d(
        _nchw(_t(x)), _t(w), _t(b), stride=2, padding=1))
    w_p, b_p, spec = tpk.pack_conv_transpose2d_weight(
        _t(w), _t(b), f_in=4, f_out=4, stride=2, padding=1)
    got = tpk.depth_to_space(tpk.packed_conv_transpose2d(
        tpk.space_to_depth(_t(x), 4), w_p, b_p, spec, out_hw=(4, 6)), 4)
    assert got.shape == ref.shape == (2, 16, 24, 5)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("op", ["instance_norm", "per_channel_linear",
                                "global_avg_pool"])
def test_packed_layer_math_matches_unpacked(rng, op):
    x = (rng.standard_normal((2, 16, 24, 8)) * 3 + 1).astype(np.float32)
    xp = tpk.space_to_depth(_t(x), 4)
    if op == "instance_norm":
        ref = _nhwc(instance_norm(_nchw(_t(x))))
        got = tpk.depth_to_space(tpk.packed_instance_norm(xp, 4), 4)
    elif op == "per_channel_linear":
        w = rng.standard_normal((6, 8)).astype(np.float32)
        b = rng.standard_normal(6).astype(np.float32)
        ref = torch.nn.functional.linear(_t(x), _t(w), _t(b))
        got = tpk.depth_to_space(
            tpk.packed_per_channel_linear(xp, _t(w), _t(b), 4), 4)
    else:
        ref = _t(x).mean(dim=(1, 2))
        got = tpk.packed_global_avg_pool(xp, 4)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# packed-row channel attention (the plain version on the CPU)
# ---------------------------------------------------------------------------

def packed_attention_case(rng, C, shape=(2, 16, 16)):
    """A packed input with one all-zero window, and (out, in) weights."""
    B, H, W = shape
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    x[0, :4, :4] = 0.0
    return (np.asarray(jpk.space_to_depth(x, 4)),
            (rng.standard_normal((3 * C, C)) * 0.3).astype(np.float32),
            rng.standard_normal(3 * C).astype(np.float32),
            (rng.standard_normal((C, C)) * 0.3).astype(np.float32),
            rng.standard_normal(C).astype(np.float32))


@pytest.mark.parametrize("C", [8, 16])
def test_packed_attention_plain_matches_jax(rng, C):
    xp, wq, bq, wp, bp = packed_attention_case(rng, C)
    ref = np.asarray(jpk.packed_window_channel_attention(
        xp, wq.T, bq, wp.T, bp, f=4))
    got = packed_window_channel_attention(*map(_t, (xp, wq, bq, wp, bp)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    # the same op as the NHWC LocalAttention, one relayout away
    nhwc = window_channel_attention_plain(
        depth_to_space_plain(_t(xp), 4), *map(_t, (wq, bq, wp, bp)))
    torch.testing.assert_close(got, space_to_depth_plain(nhwc, 4),
                               atol=2e-5, rtol=0)


def test_packed_wrappers_on_cpu_take_the_plain_path(rng):
    reset_launch_counts()
    args = [_t(a) for a in packed_attention_case(rng, 16)]
    torch.testing.assert_close(packed_window_channel_attention(*args),
                               packed_window_channel_attention_plain(*args),
                               atol=0, rtol=0)
    x = _t(rng.standard_normal((1, 8, 12, 3)).astype(np.float32))
    torch.testing.assert_close(window_relayout(x), space_to_depth_plain(x, 4),
                               atol=0, rtol=0)
    assert packed_window_channel_attention.launches == 0
    assert window_relayout.launches == 0


def test_packed_attention_rejects_a_lane_count_off_its_weights(rng):
    xp, wq, bq, wp, bp = packed_attention_case(rng, 8)
    with pytest.raises(ValueError, match="lanes"):
        packed_window_channel_attention(_t(xp[..., :64]), *map(
            _t, (wq, bq, wp, bp)))


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def c4_params():
    """JAX EnhancedGenerator params at c4 with one block, every entry
    numpy-seeded (non-zero biases, FiLM and norm affines)."""
    rng = np.random.default_rng(7)
    sd = {}
    for k, v in EnhancedGenerator(4, 1).state_dict().items():
        a = rng.standard_normal(tuple(v.shape)) * (0.3 if v.ndim > 1 else 0.1)
        if k.endswith(("norm1.weight", "norm2.weight")):
            a = a + 1.0
        sd[k] = a.astype(np.float32)
    return enhanced_generator_from_sd(sd)


def _port_generator(params):
    g = EnhancedGenerator(4, 1).eval()
    g.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return g


def test_pack_enhanced_generator_params_matches_jax_exactly(c4_params):
    ref = jax_pack_params(c4_params)
    got = pack_enhanced_generator_params(
        _port_generator(c4_params).state_dict())
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        prefix = k.rsplit(".", 1)[0]
        if v.ndim == 4:   # OIHW -> HWIO; the transposed convs IOHW -> HWIO
            v = v.permute(2, 3, 0, 1) if prefix in TRANSPOSED else \
                v.permute(2, 3, 1, 0)
        elif v.ndim == 2 and (".3." in k or ".4." in k):   # (out, in) 1x1
            v = v.T
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_packed_forward_matches_jax_and_the_nhwc_forward(c4_params):
    x = np.tanh(np.random.default_rng(3).standard_normal(
        (2, 64, 96, 3))).astype(np.float32)
    ref = np.asarray(jax.jit(jax_packed_apply)(jax_pack_params(c4_params),
                                               jnp.asarray(x)))
    g = _port_generator(c4_params)
    packed = PackedEnhancedGenerator(g).eval()
    with torch.inference_mode():
        got = _nhwc(packed(_nchw(_t(x))))
        nhwc = _nhwc(g.to(memory_format=torch.channels_last)(_nchw(_t(x))))
        functional = packed_enhanced_generator_apply(packed.packed_weights(),
                                                     _t(x))
    assert got.shape == (2, 64, 96, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), nhwc.numpy(), atol=2e-4,
                               rtol=2e-4)
    torch.testing.assert_close(functional, got, atol=0, rtol=0)


def test_packed_engine_rejects_sides_off_multiples_of_32(c4_params):
    """Sides that are multiples of 16 run since (the NHWC generator's own
    rule; ``test_packed_forward_at_odd_packed_grids``); others raise."""
    packed = PackedEnhancedGenerator(_port_generator(c4_params))
    with torch.inference_mode(), pytest.raises(ValueError, match="16"):
        packed(torch.zeros(1, 3, 40, 64))


def _masked_packed_window8_mhsa(tokens_p, qkv_w, qkv_b, proj_w, proj_b, dim):
    """JAX's ``_packed_window8_mhsa`` (packed_generator.py:198-239) with
    the padded keys of an odd packed grid masked out of the softmax, as
    its NHWC block masks them (structural_transformer.py:132-141)."""
    from multi_style_transfer_gan_tpu.models import packed_generator as jpg
    from multi_style_transfer_gan_tpu.models.structural_transformer import (
        default_num_heads,
    )

    B, Hp, Wp, _ = tokens_p.shape
    P = 16
    heads = default_num_heads(dim)
    hd = dim // heads
    qkv = jpg.packed_per_channel_linear(tokens_p, qkv_w.T, qkv_b, 4)
    ph, pw = Hp % 2, Wp % 2
    pad = ((0, 0), (0, ph), (0, pw), (0, 0))
    qkv = jnp.pad(qkv, pad)
    valid = jnp.pad(jnp.ones((B, Hp, Wp, P)), pad)
    Hq, Wq = Hp + ph, Wp + pw
    win = lambda t, c: t.reshape(B, Hq // 2, 2, Wq // 2, 2, P, c).transpose(
        0, 1, 3, 2, 4, 5, 6).reshape(-1, 4 * P, c)
    q, k, v = jnp.split(win(qkv, 3 * dim), 3, axis=-1)
    keys = win(valid[..., None], 1)[..., 0]
    heads_of = lambda u: u.reshape(u.shape[0], 4 * P, heads, hd).transpose(
        0, 2, 1, 3)
    q, k, v = heads_of(q), heads_of(k), heads_of(v)
    attn = jnp.einsum("bhtd,bhsd->bhts", q, k,
                      preferred_element_type=jnp.float32) / np.sqrt(hd)
    attn = jnp.where(keys[:, None, None, :] > 0, attn, -jnp.inf)
    attn = jax.nn.softmax(attn, axis=-1).astype(v.dtype)
    out = jnp.einsum("bhts,bhsd->bhtd", attn, v,
                     preferred_element_type=jnp.float32).astype(tokens_p.dtype)
    out = out.transpose(0, 2, 1, 3).reshape(B, Hq // 2, Wq // 2, 2, 2, P, dim)
    out = out.transpose(0, 1, 3, 2, 4, 5, 6).reshape(B, Hq, Wq, P * dim)
    return jpg.packed_per_channel_linear(out[:, :Hp, :Wp], proj_w.T, proj_b,
                                         4)


def test_packed_forward_at_odd_packed_grids(c4_params, monkeypatch):
    """At 48 x 80 the packed token grid is 3 x 5 (odd) and the block's
    window-8 grid 12 x 20 (ragged). The port's packed engine equals its
    NHWC generator and JAX's packed engine with the padded keys masked; JAX's
    packed engine as it stands zero-pads qkv without the mask and computes
    another function than its own NHWC generator there."""
    from multi_style_transfer_gan_tpu.models import enhanced_generator_apply
    from multi_style_transfer_gan_tpu.models import packed_generator as jpg

    x = np.tanh(np.random.default_rng(3).standard_normal(
        (2, 48, 80, 3))).astype(np.float32)
    packed_p = jax_pack_params(c4_params)
    unmasked = np.asarray(jax.jit(jax_packed_apply)(packed_p, jnp.asarray(x)))
    jax_nhwc = np.asarray(jax.jit(enhanced_generator_apply)(c4_params,
                                                            jnp.asarray(x)))
    monkeypatch.setattr(jpg, "_packed_window8_mhsa",
                        _masked_packed_window8_mhsa)
    jax.clear_caches()
    masked = np.asarray(jax.jit(jax_packed_apply)(packed_p, jnp.asarray(x)))
    jax.clear_caches()
    g = _port_generator(c4_params)
    with torch.inference_mode():
        got = _nhwc(PackedEnhancedGenerator(g).eval()(_nchw(_t(x))))
        nhwc = _nhwc(g.to(memory_format=torch.channels_last)(_nchw(_t(x))))
    assert got.shape == (2, 48, 80, 3)
    for ref in (masked, jax_nhwc, nhwc.numpy()):
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)
    assert np.abs(unmasked - jax_nhwc).max() > 0.5


# ---------------------------------------------------------------------------
# the uint8 program, the dispatch and the folder path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return load_generator(TRAINED, device="cpu")


def test_packed_batch_fn_matches_the_jax_packed_program(model):
    """The trained c16 weights, uint8 -> uint8 at 64^2: at most 1 level
    from the JAX packed program, and the same as the port's NHWC one."""
    from multi_style_transfer_gan_tpu.data.synthetic import render_photo

    batch = np.stack([render_photo(900200 + i, size=64)
                      for i in range(2)]).astype(np.uint8)
    ref = np.asarray(jax_make_batch_fn(
        jax_load_generator(TRAINED), "cyclegan", "enhanced", 0.8, 0.7, True,
        True, engine="packed")(batch))
    got = make_batch_fn(model, "cyclegan", engine="packed", device="cpu")(batch)
    nhwc = make_batch_fn(model, "cyclegan", engine="nhwc", device="cpu")(batch)
    assert got.dtype == torch.uint8 and got.shape == batch.shape
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
    assert np.abs(got.numpy().astype(int) - nhwc.numpy().astype(int)).max() <= 1


def test_select_engine_matches_jax():
    for kind in ("enhanced", "plain"):
        for batch in (1, 2, 3, 8, 16, 31, 32, 33, 64, 96, 128):
            for canvas in (64, 256, 512, 1024):
                assert select_engine(batch, canvas, kind) == \
                    jax_select_engine(batch, canvas, kind), (batch, canvas, kind)
    assert select_engine(8, 256) == "packed" and select_engine(64, 256) == "nhwc"


@pytest.mark.parametrize("engine,match", [("auto", "select_engine"),
                                          ("tiled", "engine must be")])
def test_batch_fn_rejects_an_unresolved_engine(model, engine, match):
    with pytest.raises(ValueError, match=match):
        make_batch_fn(model, engine=engine, device="cpu")


def test_batch_process_auto_takes_packed_on_a_small_folder(model, tmp_path):
    from PIL import Image

    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(5)
    sizes = [(80, 50), (40, 72), (64, 64)]
    for i, (w, h) in enumerate(sizes):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            src / f"img{i}.png")
    buf = io.StringIO()
    with redirect_stdout(buf):
        stats = batch_process(model, src, out, canvas=64, decode_workers=2,
                              device="cpu")
    assert "engine=auto -> packed (batch 4, canvas 64)" in buf.getvalue()
    assert stats["processed"] == 3
    for i, size in enumerate(sizes):
        with Image.open(out / "cyclegan_photo2monet" / f"img{i}.png") as img:
            assert img.size == size


def test_batch_cli_passes_the_engine_through(monkeypatch, tmp_path):
    from multi_style_transfer_gan_tpu_torch.cli import batch_process_images

    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr("multi_style_transfer_gan_tpu_torch.pipelines."
                        "load_generator", lambda *a, **k: model_stub)
    monkeypatch.setattr("multi_style_transfer_gan_tpu_torch.pipelines."
                        "batch_process", lambda *a, **k: seen.update(k))
    model_stub = type("M", (), {"kind": "enhanced", "channels": 16})()
    models = tmp_path / "models"
    models.mkdir()
    (models / "cyclegan_epoch_200.pth").write_bytes(b"")
    for engine in ("auto", "packed", "nhwc"):
        assert batch_process_images.main(
            ["--models_dir", str(models), "--engine", engine]) == 0
        assert seen["engine"] == engine


# ---------------------------------------------------------------------------
# kernel vs plain on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest tests/ -m gpu` "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# bf16: both sides compute in fp32 from the same bf16 inputs and round once
BF16_TOL = dict(atol=3e-2, rtol=2 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,shape", [(16, (2, 16, 16)), (32, (1, 16, 32)),
                                     (64, (3, 8, 12))])
def test_packed_attention_kernel_matches_plain(rng, cuda, C, shape, dtype):
    args = [_t(a).to(cuda, dtype) for a in packed_attention_case(rng, C, shape)]
    n0 = packed_window_channel_attention.launches
    got = packed_window_channel_attention(*args)
    torch.cuda.synchronize()
    assert packed_window_channel_attention.launches == n0 + 1
    ref = packed_window_channel_attention_plain(*args)
    assert torch.isfinite(got).all()
    tol = dict(atol=1e-4, rtol=0) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [3, 64])
def test_relayout_kernel_is_bit_exact(rng, cuda, C, dtype):
    x = _t(rng.standard_normal((2, 32, 48, C)).astype(np.float32)).to(cuda, dtype)
    n0 = window_relayout.launches
    rows = window_relayout(x)
    back = window_relayout(rows, inverse=True)
    torch.cuda.synchronize()
    assert window_relayout.launches == n0 + 2
    assert torch.equal(rows, space_to_depth_plain(x, 4))
    assert torch.equal(back, x)


@pytest.mark.gpu
def test_packed_kernels_raise_under_grad(rng, cuda):
    args = [_t(a).to(cuda) for a in packed_attention_case(rng, 16)]
    args[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference kernel"):
        packed_window_channel_attention(*args)
    x = torch.zeros(1, 8, 8, 3, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference kernel"):
        window_relayout(x)


@pytest.mark.gpu
def test_packed_program_on_the_card_matches_cpu(cuda, model):
    batch = (np.random.default_rng(0).random((2, 64, 64, 3)) * 255).astype(
        np.uint8)
    reset_launch_counts()
    got = make_batch_fn(load_generator(TRAINED, device=cuda), engine="packed",
                        device=cuda)(batch).cpu().numpy()
    assert packed_window_channel_attention.launches == 4
    assert window_relayout.launches == 5
    assert fused_structural_block.launches == 1
    assert window_channel_attention.launches == 0
    ref = make_batch_fn(model, engine="packed", device="cpu")(batch).numpy()
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
