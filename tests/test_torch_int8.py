"""The port's int8 serving engine (``models/quantized_generator.py``) vs
the JAX package's, on the CPU.

The int8 convolution's plain version is held to JAX's XLA int8
convolutions bit for bit in int32 at each site kind of the generator, and
an emulation of the CUDA kernel's addressing (its implicit-GEMM rows, taps
and transposed-conv phases) to the plain version. The quantization helpers,
the whole int8 parameter tree, the int32 -> bf16 cast and the one-pass
InstanceNorm are held to JAX's exactly or to a stated tolerance, the
calibration scales to a stated rtol. The whole int8 forward, and each entry
point (the batch CLI, ``direct_transform --precision int8``, the server's
int8 engine, the GUI's model manager), are held in the form of the bf16
gate: the int8 network is chaotic (one bf16 ulp that flips one int8
rounding moves outputs by many levels), so its output is held to the fp32
program at 1.25 times JAX's own int8 program's distance on the same images.
``chip_smoke.JAX_INT8_DISTANCE`` is recomputed from JAX here.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import chip_smoke as smoke
from multi_style_transfer_gan_tpu.core.norm import _in_act_fwd_math
from multi_style_transfer_gan_tpu.models import (
    enhanced_generator_apply as jax_enhanced_apply,
)
from multi_style_transfer_gan_tpu.models import quantized_generator as jq
from multi_style_transfer_gan_tpu.weights.torch_import import (
    enhanced_generator_from_sd,
)
from multi_style_transfer_gan_tpu_torch.models import EnhancedGenerator
from multi_style_transfer_gan_tpu_torch.models import quantized_generator as tq
from multi_style_transfer_gan_tpu_torch.ops.kernels.int8_conv import (
    Int8ConvSpec, _epilogue, int8_conv, int8_conv_plain, pack_weight,
    quantize_act, unpack_weight,
)
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

TRAINED = smoke.TRAINED
GATE = smoke.BF16_GATE_FACTOR
# calibration scales, port vs JAX: both calibrate on a bf16 forward, whose
# rounding differs between XLA and PyTorch in the last place here and there
# and drifts through the network (largest at up1 and up2: 0.049 on the
# trained c16 at 64^2)
CALIB_RTOL = 0.1
# the one-pass InstanceNorm: the sums are exact in fp32 on the test's
# accumulators (see the test); rsqrt may differ in the last fp32 place,
# which the bf16 output rounding hides but for a tie: one bf16 step
IN_BF16_STEPS = 1

# (name, Cin, Cout, kernel, stride, padding, dilation, transposed): the
# site kinds of the generator (quantized_generator.py:258-308)
SITES = {
    "stem 7x7 p3": (3, 16, 7, 1, 3, 1, False),
    "down 4x4 s2": (16, 32, 4, 2, 1, 1, False),
    "branch1 1x1": (32, 8, 1, 1, 0, 1, False),
    "branch2 3x3 d1": (32, 8, 3, 1, 1, 1, False),
    "branch3 3x3 d2": (32, 8, 3, 1, 2, 2, False),
    "branch4 3x3 d4": (16, 4, 3, 1, 4, 4, False),
    "convT 4x4 s2": (32, 16, 4, 2, 1, 1, True),
    "output 7x7 to 3": (16, 3, 7, 1, 3, 1, False),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _site_case(rng, name, stress):
    """x (bf16-valued fp32, NHWC), s_in, HWIO int8 weight, s_w, bias."""
    cin, cout, k, *_ = SITES[name]
    if stress:   # every value and weight at +-127 after quantization
        s = np.full(cin, 2.0 ** -7, np.float32)
        x = np.where(rng.random((2, 12, 20, cin)) < 0.5, -127, 127) * s
        w = np.where(rng.random((k, k, cin, cout)) < 0.5, -127, 127)
    else:
        s = rng.uniform(0.008, 0.03, cin).astype(np.float32)
        x = rng.standard_normal((2, 12, 20, cin)) * 2
        w = rng.integers(-127, 128, (k, k, cin, cout))
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return (x, s, w.astype(np.int8),
            rng.uniform(1e-5, 1e-3, cout).astype(np.float32),
            rng.standard_normal(cout).astype(np.float32))


def _spec(name):
    return Int8ConvSpec(*SITES[name])


def _torch_layout(w_hwio, spec):
    """JAX's HWIO int8 weight in PyTorch's layout (IOHW if transposed)."""
    w = _t(w_hwio)
    return (w.permute(2, 3, 0, 1) if spec.transposed
            else w.permute(3, 2, 0, 1)).contiguous()


# ---------------------------------------------------------------------------
# the convolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stress", [False, True], ids=["random", "127"])
@pytest.mark.parametrize("name", list(SITES))
def test_plain_int8_conv_matches_jax_bit_for_bit(name, stress):
    x, s, w, s_w, bias = _site_case(np.random.default_rng(1), name, stress)
    spec = _spec(name)
    x8 = jq.quantize_act(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s))
    if spec.transposed:
        acc = jq._convt_i8_k4s2p1(x8, jnp.asarray(w))
    else:
        acc = jq._conv_i8(x8, jnp.asarray(w), stride=spec.stride,
                          padding=spec.padding, dilation=spec.dilation)
    wp = pack_weight(_torch_layout(w, spec), spec)
    assert torch.equal(unpack_weight(wp, spec), _torch_layout(w, spec))
    xb = _t(x).bfloat16()
    got = int8_conv(xb, _t(s), wp, spec, "int32")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(acc))
    # the two epilogues, as the JAX engine casts (:235-245)
    bf = int8_conv(xb, _t(s), wp, spec, "bf16")
    np.testing.assert_array_equal(
        bf.float().numpy(), np.asarray(acc.astype(jnp.bfloat16), np.float32))
    deq = int8_conv(xb, _t(s), wp, spec, "dequant", _t(s_w), _t(bias))
    ref = ((acc.astype(jnp.float32) * jnp.asarray(s_w) + jnp.asarray(bias))
           .astype(jnp.bfloat16))
    np.testing.assert_array_equal(deq.float().numpy(),
                                  np.asarray(ref, np.float32))


def _emulate_kernel(x, s, w, spec):
    """csrc/int8_conv.cu's addressing in numpy: for each output phase (4 of
    the transposed conv, each a 2x2 conv with padding 1 - p and output row
    2u + p), each GEMM row m = (b, ho, wo) and each k = (kh, kw, cin) of
    the padded K, the quantized tap of the input (0 in the padding), times
    the phase's rows of the packed weight; int64 sums."""
    B, H, W, cin = x.shape
    tr = spec.transposed
    taps = spec.taps
    Ho, Wo = (H, W) if tr else spec.out_hw(H, W)
    stride, dil = (1, 1) if tr else (spec.stride, spec.dilation)
    xq = quantize_act(x, s).numpy().astype(np.int64)
    out = np.zeros((B,) + spec.out_hw(H, W) + (spec.cout,), np.int64)
    m = np.arange(B * Ho * Wo)
    b, ho, wo = m // (Ho * Wo), (m // Wo) % Ho, m % Wo
    for phase in range(w.shape[0]):
        py, px = phase >> 1, phase & 1
        pad_h, pad_w = (1 - py, 1 - px) if tr else (spec.padding,) * 2
        A = np.zeros((len(m), w.shape[2]), np.int64)
        for k in range(spec.k):
            tap, c = divmod(k, cin)
            kh, kw = divmod(tap, taps)
            hi = ho * stride - pad_h + kh * dil
            wi = wo * stride - pad_w + kw * dil
            ok = (hi >= 0) & (hi < H) & (wi >= 0) & (wi < W)
            A[ok, k] = xq[b[ok], hi[ok], wi[ok], c]
        acc = A @ w[phase].numpy().astype(np.int64).T
        os_, oy, ox = (2, py, px) if tr else (1, 0, 0)
        out[b, ho * os_ + oy, wo * os_ + ox] = acc[:, :spec.cout]
    return out


@pytest.mark.parametrize("name", list(SITES))
def test_kernel_addressing_emulation_matches_the_plain_version(name):
    x, s, w, _, _ = _site_case(np.random.default_rng(2), name, False)
    spec = _spec(name)
    wp = pack_weight(_torch_layout(w, spec), spec)
    assert wp.shape[1] % 8 == 0 and wp.shape[2] % 32 == 0
    got = _emulate_kernel(_t(x).bfloat16(), _t(s), wp, spec)
    ref = int8_conv_plain(_t(x).bfloat16(), _t(s), wp, spec, "int32")
    np.testing.assert_array_equal(got, ref.numpy())


def test_int8_conv_writes_a_channel_slice_and_checks_its_out():
    x, s, w, _, _ = _site_case(np.random.default_rng(3), "branch2 3x3 d1",
                               False)
    spec = _spec("branch2 3x3 d1")
    wp = pack_weight(_torch_layout(w, spec), spec)
    xb = _t(x).bfloat16()
    cat = torch.zeros(2, 12, 20, 32, dtype=torch.bfloat16)
    int8_conv(xb, _t(s), wp, spec, out=cat, channel_offset=8)
    torch.testing.assert_close(cat[..., 8:16], int8_conv(xb, _t(s), wp, spec),
                               atol=0, rtol=0)
    assert not cat[..., :8].any() and not cat[..., 16:].any()
    with pytest.raises(ValueError, match="does not hold"):
        int8_conv(xb, _t(s), wp, spec, out=cat, channel_offset=28)
    with pytest.raises(ValueError, match="mode"):
        int8_conv(xb, _t(s), wp, spec, "fp8")


def test_int32_to_bf16_cast_matches_jax_past_2_24():
    """Past 2^24 an int32 -> bf16 cast through fp32 rounds twice; XLA's and
    PyTorch's CPU casts both do (the kernel rounds the same way)."""
    rng = np.random.default_rng(4)
    vals = [rng.integers(2 ** e, 2 ** (e + 1), 500) for e in range(20, 31)]
    # values a few units off a bf16 midpoint, where the two roundings and
    # one rounding part
    vals.append(np.array([2 ** e + 2 ** (e - 8) + d for e in range(25, 31)
                          for d in range(-40, 41)]))
    a = np.concatenate([np.concatenate(vals), -np.concatenate(vals)])
    a = a.astype(np.int32)
    got = _epilogue(_t(a), "bf16", None, None).float().numpy()
    ref = np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(got, ref)
    once = torch.from_numpy(a).double()
    m, e = torch.frexp(once)
    once = (torch.round(m * 256) * torch.pow(2.0, (e - 8).double())).numpy()
    assert (got != once).any()   # the cast is not one rounding


# ---------------------------------------------------------------------------
# quantization, statistics, calibration
# ---------------------------------------------------------------------------

def test_quantize_weight_and_act_match_jax_with_ties():
    rng = np.random.default_rng(5)
    # an OIHW weight whose channels' max is 127: scale 1, and .5 ties
    w = rng.integers(-126, 127, (6, 4, 3, 3)) + 0.5
    w[:, 0, 0, 0] = 127.0
    w[0] = rng.standard_normal((4, 3, 3)) * 1e-3
    w[1] = 0.0                                   # max(m, 1e-12)
    w = w.astype(np.float32)
    q, s = tq.quantize_weight(_t(w))
    jqw, js = jq.quantize_weight(jnp.asarray(w.transpose(2, 3, 1, 0)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw).transpose(
        3, 2, 0, 1))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    qt, st = tq.quantize_weight(_t(w.transpose(1, 0, 2, 3)), out_axis=1)
    np.testing.assert_array_equal(qt.numpy(), q.numpy().transpose(1, 0, 2, 3))
    # activations: .5 ties of x / s, and values past +-127
    sc = np.float32(2.0 ** -5)
    x = np.concatenate([np.arange(-300, 301) + 0.5, rng.standard_normal(64)
                        * 200]).astype(np.float32) * sc
    x = x.reshape(-1, 1) * np.ones((1, 3), np.float32)
    s3 = np.array([sc, 0.013, 0.7], np.float32)
    np.testing.assert_array_equal(
        tq.quantize_act(_t(x), _t(s3)).numpy(),
        np.asarray(jq.quantize_act(jnp.asarray(x), jnp.asarray(s3))))


@pytest.fixture(scope="module")
def c8():
    """A seeded c8 EnhancedGenerator and the same weights as JAX params."""
    g = EnhancedGenerator(8, 1, generator=torch.Generator().manual_seed(0))
    g = g.eval().to(memory_format=torch.channels_last)
    p = enhanced_generator_from_sd({k: v.numpy()
                                    for k, v in g.state_dict().items()})
    return g, p


def test_int8_parameter_tree_matches_jax_bit_for_bit(c8):
    g, p = c8
    rng = np.random.default_rng(6)
    scales = {s: rng.uniform(1e-3, 0.1, g.get_submodule(s).in_channels)
              .astype(np.float32) for s in filter(None, map(
                  tq._site_of, g.state_dict()))}
    ref = jq.quantize_enhanced_generator_params(p, scales)
    got = tq.quantize_enhanced_generator(g, scales)
    assert sorted(got.site_names) == sorted(ref["weights_q"])
    assert sorted(ref["bias"]) == ["output.0"]
    for site in got.site_names:
        m = got.site(site)
        w = unpack_weight(m.weight, m.spec)
        w = w.permute(2, 3, 0, 1) if m.spec.transposed else w.permute(
            2, 3, 1, 0)
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(ref["weights_q"][site]))
        np.testing.assert_array_equal(m.weight_scale.numpy(),
                                      np.asarray(ref["weight_scale"][site]))
        np.testing.assert_array_equal(m.act_scale.numpy(), scales[site])
        assert (m.bias is None) == (site not in ref["bias"])
    np.testing.assert_array_equal(got.site("output.0").bias.numpy(),
                                  np.asarray(ref["bias"]["output.0"]))


def test_onepass_in_matches_jax_on_near_flat_accumulators():
    """bf16 accumulators of ~1e6 within one binade over 16 x 16 positions:
    every sum and square sum is exact in fp32 (squares of 8-bit
    significands in one binade, 256 of them), so both packages' one-pass
    statistics agree whatever their summation order; the near-flat
    channels (a few values one bf16 step off) are where E[x^2] - E[x]^2
    cancels to (or below) 0 and is clamped."""
    rng = np.random.default_rng(7)
    base = rng.uniform(2 ** 20, 2 ** 20 * 1.5, (2, 1, 1, 24))
    steps = rng.integers(-40, 40, (2, 16, 16, 24))
    steps[..., :8] = 0
    steps[..., :8][rng.random((2, 16, 16, 8)) < 0.02] = 1   # near flat
    x = np.asarray(jnp.asarray(base + steps * 2.0 ** 13, jnp.bfloat16))
    ref = np.asarray(_in_act_fwd_math(jnp.asarray(x), 1e-5, 0.0)[0]
                     .astype(jnp.bfloat16), np.float32)
    got = tq.in_relu_onepass(_t(x.astype(np.float32)).bfloat16())
    got = got.float().numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got - ref) <= IN_BF16_STEPS * step).all()
    # where the engine must take this call: the port's core.norm route
    # (Welford statistics) lands elsewhere on the near-flat channels
    from multi_style_transfer_gan_tpu_torch.core.norm import in_relu

    welford = in_relu(_t(x.astype(np.float32)).bfloat16().permute(0, 3, 1, 2))
    welford = welford.permute(0, 2, 3, 1).float().numpy()
    assert (np.abs(welford - ref)[..., :8] > step[..., :8]).any()


@pytest.fixture(scope="module")
def trained():
    """The trained c16 on the CPU (port) and as JAX params, a calibration
    batch at 64^2 and JAX's qparams from it."""
    from multi_style_transfer_gan_tpu.pipelines import (
        load_generator as jax_load_generator,
    )

    model = load_generator(TRAINED, device="cpu")
    jmodel = jax_load_generator(TRAINED)
    x = np.stack(smoke.gate_images(256)[:4, ::4, ::4]).astype(np.float32)
    x = x / 255.0 * 2.0 - 1.0
    scales = jq.calibrate_enhanced_generator(jmodel.params, [x])
    scales["initial.0"] = np.full(3, 1.0 / 127.0, np.float32)
    qp = jax.tree_util.tree_map(
        np.asarray, jq.quantize_enhanced_generator_params(jmodel.params,
                                                          scales))
    return model, jmodel, x, qp


def test_calibration_scales_match_jax(trained):
    model, _, x, qp = trained
    got = tq.calibrate_enhanced_generator(model.module, [x])
    assert sorted(got) == sorted(qp["act_scales"])
    for site, ref in qp["act_scales"].items():
        if site == "initial.0":   # prepare_int8_model pins it
            continue
        np.testing.assert_allclose(got[site], ref, rtol=CALIB_RTOL,
                                   err_msg=site)
    pinned = tq.prepare_int8_model(model.module, [x]).site("initial.0")
    assert (pinned.act_scale == np.float32(1.0 / 127.0)).all()


def _u8(y):
    """[-1, 1] NHWC model output -> uint8, as the programs round."""
    y = np.asarray(y, np.float32)
    return np.clip(np.round((y + 1) / 2 * 255.0), 0, 255).astype(np.uint8)


def _gate(got, ref, jax_int8):
    """``got`` (the port's int8 uint8 output) from ``ref`` (fp32) within
    GATE times JAX's own int8 output's mean |d|, as ``chip_smoke.int8_gate``
    (the share past BF16_GATE_LEVELS is ~90% for JAX's too, so 1.25 times
    it cannot bind)."""
    mean, share = smoke.bf16_distance(got, ref)
    jmean, jshare = smoke.bf16_distance(jax_int8, ref)
    assert mean <= GATE * jmean, (mean, share, jmean, jshare)
    return mean, jmean


@pytest.fixture(scope="module")
def jax_trace(trained):
    """JAX's int8 forward on the trained fixture's qparams and images, step
    by step, in ``chip_smoke.int8_trace``'s form (bf16 tensors, NHWC): each
    convolution's, InstanceNorm's, attention's and block's input and
    output, recorded from one jitted forward compiled without XLA's excess
    precision. With it (XLA's default), a fusion may quantize a value
    before its rounding to bf16: the MSB branches quantize the attention's
    fp32 output, so many of their sums differ from those of the bf16 value
    the program records and eager JAX and the port quantize."""
    _, _, x, qp = trained
    saved = {k: getattr(jq, k) for k in (
        "_q_conv", "in_relu", "_q_attention", "structural_transformer_apply")}
    steps = {"conv": {}, "in": [], "attention": [], "block": []}

    def conv(qp_, params, h, site, rec, **kw):
        y = saved["_q_conv"](qp_, params, h, site, rec, **kw)
        steps["conv"][site] = (h, y)
        return y

    def in_relu(h, **kw):
        y = saved["in_relu"](h, **kw)
        steps["in"].append((h, y))
        return y

    def attention(qp_, params, h, *args, **kw):
        y = saved["_q_attention"](qp_, params, h, *args, **kw)
        steps["attention"].append((h, y))
        return y

    def block(fp, tokens, style, orig, *, grid_hw, **kw):
        y = saved["structural_transformer_apply"](fp, tokens, style, orig,
                                                  grid_hw=grid_hw, **kw)
        nhwc = lambda t: t.reshape(t.shape[0], *grid_hw, t.shape[-1])
        steps["block"].append((nhwc(tokens), style, nhwc(y)))
        return y

    def run(qp_, x_):
        y = jq.quantized_enhanced_generator_apply(qp_, x_)
        return dict(steps, out=y)

    for k, f in zip(saved, (conv, in_relu, attention, block)):
        setattr(jq, k, f)
    try:
        args = (jax.tree_util.tree_map(jnp.asarray, qp), jnp.asarray(x))
        trace = jax.jit(run).lower(*args).compile(compiler_options={
            "xla_allow_excess_precision": False})(*args)
    finally:
        for k, f in saved.items():
            setattr(jq, k, f)
    probe = jnp.asarray(smoke.int8_in_probe().float().numpy(), jnp.bfloat16)
    trace["probe"] = saved["in_relu"](probe)
    return jax.tree_util.tree_map(
        lambda a: _t(np.asarray(a.astype(jnp.float32))).bfloat16(), trace)


@pytest.fixture(scope="module")
def jax_outputs(trained):
    """JAX's fp32 and int8 programs (jitted as the package runs them) on
    the trained fixture's images, as uint8."""
    _, jmodel, x, qp = trained
    int8 = jax.jit(jq.quantized_enhanced_generator_apply)(
        jax.tree_util.tree_map(jnp.asarray, qp), jnp.asarray(x))
    fp32 = jax.jit(jax_enhanced_apply)(jmodel.params, jnp.asarray(x))
    return _u8(fp32), _u8(int8.astype(jnp.float32))


def test_int8_forward_on_jax_qparams_passes_the_gate(trained, jax_outputs):
    model, jmodel, x, qp = trained
    q = tq.from_jax_qparams(model.module, qp)
    got = q(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _gate(_u8(got.float()), *jax_outputs)


def test_int8_forward_holds_to_jax_step_by_step(trained, jax_trace):
    """Teacher-forced: each step of the port's int8 forward on JAX's
    qparams is fed JAX's input at that step and held to JAX's output
    (``chip_smoke.int8_forced``): the 26 convolutions and every step's own
    input bit for bit, so the branches' channel slices, the concatenation
    and the residuals are JAX's; the 13 one-pass InstanceNorms (and the
    near-flat probe) within one bf16 step; the attention, style vector and
    block within the bf16 kernels' tolerance."""
    model, _, x, qp = trained
    q = tq.from_jax_qparams(model.module, qp)
    assert (len(jax_trace["conv"]), len(jax_trace["in"]),
            len(jax_trace["attention"]), len(jax_trace["block"])) == \
        (26, 13, 4, 1)
    worst = smoke.int8_forced(q, _t(x).permute(0, 3, 1, 2).bfloat16(),
                              jax_trace)
    assert worst["in_steps"] <= 1 and worst["probe_steps"] <= 1, worst


@pytest.mark.parametrize("fault", smoke.INT8_FAULTS)
def test_planted_int8_fault_fails_the_step_by_step_check(trained, jax_trace,
                                                         fault):
    model, _, x, qp = trained
    q = tq.from_jax_qparams(model.module, qp)
    with smoke.int8_fault(fault), pytest.raises(AssertionError,
                                                match="int8 forced"):
        smoke.int8_forced(q, _t(x).permute(0, 3, 1, 2).bfloat16(), jax_trace)


@pytest.mark.parametrize("fault", ["residual", "branches", "convT phases"])
def test_planted_int8_fault_fails_the_gate(trained, jax_outputs, fault):
    """At 64^2 these faults also move the whole program past the int8 gate;
    Welford statistics stay inside it, and at the card's 256^2 only the
    branch swap leaves it (chip_smoke.INT8_FAULTS): the step-by-step check
    is the one that binds."""
    model, _, x, qp = trained
    q = tq.from_jax_qparams(model.module, qp)
    with smoke.int8_fault(fault):
        got = q(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    with pytest.raises(AssertionError):
        _gate(_u8(got.float()), *jax_outputs)


def test_jax_int8_distance_constant(trained):
    """``chip_smoke.JAX_INT8_DISTANCE``: JAX's int8 program on the trained
    c16, calibrated on the gate images' first 8, against its fp32 program
    on the 16 gate images at 256^2, to four significant digits."""
    from multi_style_transfer_gan_tpu.ops import to_model_range
    from multi_style_transfer_gan_tpu.pipelines.batch import make_batch_fn

    jmodel = trained[1]
    x = smoke.gate_images(256)
    calib = [to_model_range(jnp.asarray(x[:smoke.INT8_CALIB_IMAGES]))]
    fp32, int8 = (np.asarray(make_batch_fn(
        jmodel, "cyclegan", "enhanced", 0.8, 0.7, True, True, engine=e,
        calib_batches=calib)(x)) for e in ("nhwc", "int8"))
    mean, share = smoke.bf16_distance(int8, fp32)
    assert (float(f"{mean:.4g}"), float(f"{share:.4g}")) \
        == smoke.JAX_INT8_DISTANCE, (mean, share)
    # the port's calibration batch is JAX's, value for value
    np.testing.assert_array_equal(smoke.int8_calibration(x)[0],
                                  np.asarray(calib[0]))


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _write_photos(folder, sizes, seed):
    names = []
    for i, size in enumerate(sizes):
        names.append(f"photo{i}.png")
        Image.fromarray(smoke.smooth_images(np.random.default_rng(seed + i), 1,
                                            size)[0]).save(folder / names[-1])
    return names


def _read(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def test_batch_cli_int8_engine_passes_the_gate_against_jax(
        monkeypatch, capsys, tmp_path, trained):
    """``--engine int8``: calibration on the folder's first images, the
    EXPERIMENTAL warning; the outputs at 1.25 x JAX's batch_process int8
    distance from the fp32 program's."""
    from multi_style_transfer_gan_tpu.pipelines.batch import (
        batch_process as jax_batch_process,
    )
    from multi_style_transfer_gan_tpu_torch.cli import batch_process_images

    src, models = tmp_path / "in", tmp_path / "models"
    src.mkdir()
    models.mkdir()
    os.symlink(os.path.abspath(TRAINED), models / "G_BA_epoch_200.pth")
    names = _write_photos(src, [(80, 64), (64, 48), (64, 64), (72, 64)], 40)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(batch_process_images, "DEVICE", "cpu")
    flags = ["--input_dir", str(src), "--models_dir", str(models), "--mode",
             "local_style", "--local_style_mode", "simple", "--canvas", "64",
             "--batch_size", "4"]
    assert batch_process_images.main(flags + ["--output_dir",
                                              str(tmp_path / "int8"),
                                              "--engine", "int8"]) == 0
    assert "EXPERIMENTAL" in capsys.readouterr().out
    assert batch_process_images.main(flags + ["--output_dir",
                                              str(tmp_path / "fp32"),
                                              "--engine", "nhwc"]) == 0
    jax_batch_process(trained[1], str(src), str(tmp_path / "jax"),
                      mode="local_style", local_style_mode="simple",
                      batch_size=4, canvas=64, engine="int8",
                      decode_workers=2)
    sub = "local_style_simple_photo2monet"
    got, ref, jax_int8 = (np.concatenate([
        _read(tmp_path / d / sub / n).ravel() for n in names])
        for d in ("int8", "fp32", "jax"))
    _gate(got, ref, jax_int8)


def test_batch_process_int8_takes_nhwc_for_a_plain_model(tmp_path, capsys):
    from torch_oracle import make_plain_sd

    from multi_style_transfer_gan_tpu_torch.pipelines import batch_process

    path = tmp_path / "plain.pth"
    torch.save({"G_BA_state_dict": make_plain_sd(np.random.default_rng(0),
                                                 c=8)}, path)
    model = load_generator(path, device="cpu")
    src = tmp_path / "in"
    src.mkdir()
    names = _write_photos(src, [(64, 64), (40, 64)], 50)
    for engine in ("int8", "nhwc"):
        batch_process(model, src, tmp_path / engine, canvas=64,
                      decode_workers=2, engine=engine, device="cpu")
    assert "EXPERIMENTAL" in capsys.readouterr().out
    for n in names:
        np.testing.assert_array_equal(
            _read(tmp_path / "int8" / "cyclegan_photo2monet" / n),
            _read(tmp_path / "nhwc" / "cyclegan_photo2monet" / n))
    with pytest.raises(ValueError, match="enhanced models only"):
        load_generator(path, precision="int8", device="cpu")


def test_direct_transform_int8_passes_the_gate_against_jax(
        monkeypatch, capsys, tmp_path):
    from multi_style_transfer_gan_tpu.cli import (
        direct_transform as jax_direct,
    )
    from multi_style_transfer_gan_tpu_torch.cli import direct_transform

    photo = str(tmp_path / "photo.png")
    Image.fromarray(smoke.gate_photo()).save(photo)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(direct_transform, "DEVICE", "cpu")
    argv = ["--image", photo, "--model", TRAINED, "--size", "64"]
    # --spatial is not applied to an int8 model (one CPU "device" here)
    assert direct_transform.main(argv + ["--precision", "int8", "--spatial",
                                         "2", "--output",
                                         str(tmp_path / "int8.png")]) == 0
    assert "EXPERIMENTAL" in capsys.readouterr().out
    assert direct_transform.main(argv + ["--precision", "highest", "--output",
                                         str(tmp_path / "fp32.png")]) == 0
    jax_direct.main(argv + ["--precision", "int8", "--output",
                            str(tmp_path / "jax.png")])
    _gate(*(_read(tmp_path / f"{n}.png") for n in ("int8", "fp32", "jax")))


@pytest.fixture(scope="module")
def jax_synthetic_int8(trained):
    """JAX's int8 engine calibrated on its synthetic default batch, as its
    server and GUI build it (``prepare_int8_model(params, None)``)."""
    qp = jq.prepare_int8_model(trained[1].params)
    return jax.jit(lambda x: jq.quantized_enhanced_generator_apply(qp, x))


def test_server_int8_engine_passes_the_gate_against_jax(trained,
                                                        jax_synthetic_int8):
    """The service with ``engine='int8'`` (calibrated on the port's seeded
    synthetic batch) against JAX's engine on its own synthetic batch."""
    import io

    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.pipelines import make_batch_fn
    from multi_style_transfer_gan_tpu_torch.serving import (
        StyleTransferService,
    )

    model = trained[0]
    x = np.ascontiguousarray(smoke.gate_images(256)[:4, ::4, ::4])
    service = StyleTransferService(model, canvas=64, max_batch=4,
                                   engine="int8", device="cpu")
    try:
        outs = []
        for img in x:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            outs.append(np.asarray(Image.open(io.BytesIO(
                service.stylize_bytes(buf.getvalue()))).convert("RGB")))
    finally:
        service.close()
    got = np.stack(outs)
    # the service's program is make_batch_fn's with the synthetic batch
    np.testing.assert_array_equal(
        got, make_batch_fn(model, engine="int8", device="cpu")(x).numpy())
    ref = make_batch_fn(model, device="cpu")(x).numpy()
    jax_int8 = jax_synthetic_int8(to_model_range(_t(x)).numpy())
    _gate(got, ref, _u8(jax_int8.astype(jnp.float32)))


def test_gui_int8_model_manager_passes_the_gate_against_jax(tmp_path):
    """``MSTGAN_GUI_PRECISION=int8``: the enhanced model through the int8
    engine, the plain CycleGAN pair at the default precision, as JAX's
    manager loads them; the standard tab's worker on one photo."""
    from multi_style_transfer_gan_tpu.gui import app as japp
    from multi_style_transfer_gan_tpu_torch.gui import app as tapp
    from test_torch_gui import _plain_checkpoint

    os.symlink(os.path.abspath(TRAINED), tmp_path / "G_BA_epoch_200.pth")
    _plain_checkpoint(tmp_path / "cyclegan_epoch_200.pth")
    managers = [tapp.ModelManager(str(tmp_path), "int8", device="cpu"),
                tapp.ModelManager(str(tmp_path), "highest", device="cpu")]
    for m in managers:
        m.load(log=lambda msg: None)
    int8, fp32 = managers
    assert int8.loaded() == 3
    assert int8.enhanced_ba.precision == "int8"
    assert int8.cyclegan_ab.precision == int8.cyclegan_ba.precision == \
        "default"
    photo = str(tmp_path / "photo.png")
    Image.fromarray(smoke.gate_photo()).save(photo)
    jmodel = japp.ModelManager(str(tmp_path), "int8")
    jmodel.load(log=lambda msg: None)
    assert jmodel.cyclegan_ab is not None
    jm = jmodel.enhanced_ba
    assert jm.precision == "int8"
    outs = []
    for model, worker in ((int8.enhanced_ba, tapp._process_standard),
                          (fp32.enhanced_ba, tapp._process_standard),
                          (jm, japp._process_standard)):
        out = str(tmp_path / f"out{len(outs)}.png")
        worker(model, photo, out, strength=1.0, enhance_colors=False,
               smooth=0, adaptive_smooth=False)
        outs.append(_read(out))
    _gate(*outs)
