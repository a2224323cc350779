"""Where the serving kernels may round to bf16: an emulation on the CPU.

    PYTHONPATH=. python3 devtools/serving_kernel_rounding.py

The tensor-core instantiations of the windowed channel attention
(``csrc/window_channel_attention.cuh``) and of the fused structural block
(``csrc/fused_structural_block.cu``) feed operands they form themselves to
bf16 matrix products with fp32 sums: qn, kn, v, the softmax S and the
attention output in the first; the LayerNorm outputs, q, k, v, the
exponentials, the MHSA output and the GELU output in the second. This
script repeats their arithmetic in PyTorch with each such operand rounded
to bf16, either as one term or as a hi + lo pair (hi = bf16(x), lo =
bf16(x - hi); products hi hi + hi lo + lo hi), and holds the result
against the plain versions at ``chip_smoke.py``'s bound (``BF16_ATOL``,
``BF16_RTOL``) on ``chip_smoke.attention_stress_inputs`` and
``chip_smoke.block_stress_inputs`` at the serving shapes of the c8, c16,
c32 and c64 generators at canvas 256. For each rounding plan it prints the
largest |d| and its ratio to the bound ("x1.000" is at the bound);
``kernel`` is the plan the kernels use at that width
(``attention_kernel_plan``, ``block_kernel_plan``). Takes a few minutes
(the c64 shapes most of it); windows are emulated in chunks of
``ROWS_CHUNK``, so memory stays near a gigabyte.

    PYTHONPATH=. python3 devtools/serving_kernel_rounding.py --grid

runs the c24, c40, c48 and c56 generators' shapes instead
(``chip_smoke.GRID_CHANNELS``: canvas 256, and each width's down2 at canvas
512, the largest window count at its widest C), the kernel plan only (~10
minutes). Those widths run padded inside the kernels (the attention in the
layout of the next power of two, the block in the dim-128 or dim-256
design); a pad channel adds exact zeros to every sum and a pad key is out
of the softmax, so the padded arithmetic is emulated at the real width with
the plan of the layout it runs in.

    PYTHONPATH=. python3 devtools/serving_kernel_rounding.py --any

runs the attention at the LocalAttention widths of
``chip_smoke.ANY_KERNEL_CHANNELS`` (c4, c12, .., c60 and the widths of c1,
c2, c3 and c63, which no generator has but the kernel takes: C = 1 .. 252,
most of them not multiples of 8) at the same shapes, the kernel plan only.
They run in the runtime-C variant of their layout (C = 1 .. 15 in CP = 16,
where one-term S and out are the plan); the pads add exact zeros and the
pad keys are out of the softmax, so the arithmetic is emulated at the real
width. So does the block at those widths' dims from 48 on (not multiples
of 32), which runs in bf16 in the head-slot kernel with every operand a
pair (the slots' pad rows and columns add exact zeros: emulated at the
real head width and its scale); the dims up to 32 run in FMA bodies that
round nothing inside.

    PYTHONPATH=. python3 devtools/serving_kernel_rounding.py --wide

runs the widths past 64 (``chip_smoke.WIDE_FULL_CHANNELS`` and
``WIDE_SMALL_CHANNELS``: c128, c68, c72, c96, c116), the kernel plan only,
at the shapes that run in the new layouts: the attention at each width's
canvas-256 down2 (C = 4c = 272 .. 512 in the C = 512 layout, whose plan is
the C = 256 kernel's: every operand a pair) and the block at its dim 4c on
the canvas-256 grid and a ragged one (the pair kernel, every operand a
pair, the heads at their real width and scale).

    PYTHONPATH=. python3 devtools/serving_kernel_rounding.py --past128

runs the streamed designs past 128 (``chip_smoke.PAST_SERVED_CHANNELS``:
c132, c192, c256), the kernel plan only, at the largest shape each width
runs: the attention at its canvas-256 down2 on batch 8 (C = 528, 768, 1024
past C = 512: q, k and v stay fp32 in the workspace, qn, kn, v, the
exponentials and the output are pairs) and the block chain at its dim 4c on
the canvas-256 grid and a ragged one, and at dims 1072, 2032 and 2048 (16
heads of 67 and 127, 64 of 32) on a 32 x 32 grid (LN1's output in three
terms, the MHSA in fp32, the other operands pairs, the heads at their real
width and scale; beside it the plan of every operand a pair), ~20 minutes
on 4 threads.

    PYTHONPATH=. python3 devtools/serving_kernel_rounding.py --fp32

asks the fp32 question of the block instead (``fp32_block_question``, ~4
minutes): at dims 128, 256 and 512 on the stress inputs, how far an fp32
evaluation lies from a float64 one with the qkv product, the scores and
the softmax in fp32 or in float64, and with LN1 and the FiLM in float64
too.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as smoke
from devtools.train_kernel_rounding import BF16, _parts, mm, ratio
from multi_style_transfer_gan_tpu_torch.ops.kernels import fused_transformer
from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
    WINDOW, default_num_heads, structural_block_plain,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention import (
    layout_width, window_rows_attention_plain,
)


def attention_kernel_plan(C: int) -> dict:
    """The attention kernel's plan at width C, that of the layout it runs
    in (CP = ``layout_width(C, bf16=True)``): qn and kn as pairs; at CP >=
    64 also the softmax S (the apply's B operand) and the apply's output
    (the proj's A operand). At CP = 256 (``wide``) the kernel stores q and k
    as hi + lo pairs of their raw values and normalizes from those, takes
    the exponentials at the fixed shift 16 (every logit of unit vectors
    over 16 positions lies in [-16, 16]) and divides the apply's output by
    the row sums afterwards; v enters the apply as a pair too (one term: a
    saturated window on the 64^2 grid at 0.83 of the bound, the pair 0.67)."""
    cp = layout_width(C, bf16=True)
    wide = cp > 128
    # past C = 512 (the streamed design) q and k stay fp32 in the workspace:
    # no pair of their raw values
    return dict(qk=True, v=wide, S=cp >= 64, out=cp >= 64, wide=wide,
                raw=wide and C <= 512)


def block_kernel_plan(C: int) -> dict:
    """The block kernel's plan at width C, that of its design: LN1's output
    for q and k, and q and k, as pairs; in the dim-128 design (C = 96, 128)
    also LN1's output for v, LN2's output and the GELU output; in the
    dim-256 design (C = 160 .. 256) every operand the kernel forms: also the
    exponentials and v (the apply) and the MHSA output (the proj). With
    the dim-128 plan a random block at dim 256 misses the bound by 1.35x;
    with o, p and v as pairs it stays at 0.68 (saturated 0.81, a one-ulp
    flip of the output rounding). A dim that is not a multiple of 32 runs in
    the head-slot kernel (bf16), which takes the dim-256 design's plan:
    every operand a pair. The streamed chain (past dim 512, or heads wider
    than 64) enters LN1's output into the qkv product in three terms and
    runs the MHSA in fp32: with every operand a pair a saturated block at
    dim 2032 reaches 2.49 of the bound (``--past128``)."""
    if fused_transformer.stream_takes(C):
        # the streamed chain: LN1's output in three terms, the MHSA in fp32
        return dict(h_qk=3, h_v=3, qk="fp32", p="fp32", v="fp32", o=True,
                    h2=True, a=True)
    slot = C % 32 != 0
    wide, widest = C > 64 or slot, C > 128 or slot
    return dict(h_qk=True, h_v=wide, qk=True, p=widest, v=widest, o=widest,
                h2=wide, a=wide)


# operand -> split into hi + lo (True) or one bf16 term (False); None: the
# kernel's own plan at the shape's width
ATTENTION_PLANS = {
    "all one term": dict(qk=False, v=False, S=False, out=False),
    "qn, kn pairs only": attention_kernel_plan(16),
    "wide, S and out one term": dict(qk=True, v=False, S=False, out=False,
                                     wide=True),
    "kernel": None,
}
BLOCK_PLANS = {
    "all one term": dict(h_qk=False, h_v=False, qk=False, p=False, v=False,
                         o=False, h2=False, a=False),
    "h split": dict(h_qk=True, h_v=False, qk=False, p=False, v=False,
                    o=False, h2=False, a=False),
    "q, k split": dict(h_qk=False, h_v=False, qk=True, p=False, v=False,
                       o=False, h2=False, a=False),
    "h, q, k pairs only": block_kernel_plan(64),
    "dim-128 pairs": block_kernel_plan(128),
    "every operand a pair": block_kernel_plan(256),
    "kernel": None,
}


def attention_chain(t, wqkv, bqkv, wproj, bproj, plan, eps=1e-12):
    """The attention kernel's arithmetic on (R, 16, C) bf16 windows: the
    qkv product is exact (bf16 inputs, fp32 sums); qn and kn enter the Gram,
    v and S the apply, the attention output the proj."""
    C = t.shape[-1]
    f = lambda a: a.float()
    qkv = F.linear(f(t), f(wqkv).reshape(3 * C, C), f(bqkv))
    q, k, v = qkv.split(C, dim=-1)
    wide = plan.get("wide", False)
    if wide and plan.get("raw", True):   # raw q and k as hi + lo pairs
        q, k = (sum(_parts(u, True)) for u in (q, k))
    inv = lambda u: 1.0 / torch.clamp_min(
        u.square().sum(-1, keepdim=True).sqrt(), eps)
    qn, kn = q * inv(q), k * inv(k)
    g = mm(qn.transpose(1, 2), kn, plan["qk"], plan["qk"])
    if wide:
        e = torch.exp(g - 16.0)
        out = (mm(v, e.transpose(1, 2), plan["v"], plan["S"])
               / e.sum(-1).unsqueeze(1))
    else:
        out = mm(v, torch.softmax(g, -1).transpose(1, 2), plan["v"],
                 plan["S"])
    y = mm(out, f(wproj).reshape(C, C).t(), plan["out"], False) + f(bproj)
    return y.to(t.dtype)


def _windows(x):
    """(B, H, W, C) with H, W multiples of 8 -> (B nh nw, 64, C)."""
    B, H, W, C = x.shape
    nh, nw = H // WINDOW, W // WINDOW
    t = x.reshape(B, nh, WINDOW, nw, WINDOW, C).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, WINDOW * WINDOW, C)


def _unwindows(t, B, H, W):
    nh, nw = H // WINDOW, W // WINDOW
    t = t.reshape(B, nh, nw, WINDOW, WINDOW, -1).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, H, W, -1)


def block_chain(x, struct, gamma, beta, plan, *, norm1_w, norm1_b, qkv_w,
                qkv_b, proj_w, proj_b, norm2_w, norm2_b, fc1_w, fc1_b, fc2_w,
                fc2_b, eps=1e-5):
    """The block kernel's arithmetic on (B, H, W, C) bf16 tokens: LayerNorm
    statistics, the softmax and the GELU are fp32; the LN outputs h and h2,
    q and k (the scores), the exponentials and v (the apply), the MHSA
    output o (the proj) and the GELU output a (fc2) are rounded to bf16."""
    B, H, W, C = x.shape
    f = lambda a: a.float()
    heads = default_num_heads(C)
    hd = C // heads
    xf = f(x)
    h = F.layer_norm(xf + f(struct), (C,), f(norm1_w), f(norm1_b), eps)
    h = h * (1.0 + f(gamma)[:, None, None, :]) + f(beta)[:, None, None, :]
    w = f(qkv_w).t()
    qkv = torch.cat([mm(h, w[:, :2 * C], plan["h_qk"], False),
                     mm(h, w[:, 2 * C:], plan["h_v"], False)], -1) + f(qkv_b)
    ph, pw = (-H) % WINDOW, (-W) % WINDOW
    qkv = F.pad(qkv, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    t = _windows(qkv).reshape(-1, WINDOW * WINDOW, 3, heads, hd)
    q, k, v = t.permute(2, 0, 3, 1, 4)                  # (Bw, heads, T, hd)
    s = mm(q, k.transpose(-2, -1), plan["qk"], plan["qk"])
    valid = _windows(F.pad(torch.ones(1, H, W, 1), (0, 0, 0, pw, 0, ph)))
    valid = valid.reshape(1, -1, 1, 1, WINDOW * WINDOW) > 0
    s = s.reshape(B, -1, heads, WINDOW * WINDOW, WINDOW * WINDOW)
    s = s.masked_fill(~valid, float("-inf")).flatten(0, 1)
    e = torch.exp((s - s.amax(-1, keepdim=True)) * (1.0 / math.sqrt(hd)))
    o = mm(e, v, plan["p"], plan["v"]) / e.sum(-1, keepdim=True)
    o = _unwindows(o.permute(0, 2, 1, 3).reshape(-1, WINDOW * WINDOW, C),
                   B, Hp, Wp)[:, :H, :W]
    xf = xf + mm(o, f(proj_w).t(), plan["o"], False) + f(proj_b)
    h2 = F.layer_norm(xf, (C,), f(norm2_w), f(norm2_b), eps)
    a = F.gelu(mm(h2, f(fc1_w).t(), plan["h2"], False) + f(fc1_b))
    return (xf + mm(a, f(fc2_w).t(), plan["a"], False) + f(fc2_b)).to(x.dtype)


ROWS_CHUNK = 512   # windows emulated at a time


def attention_ratios(shapes=None, plans=None):
    """{(shape, label, plan): (max |d|, ratio to the bound)} of the
    attention chain on the packed-row stress inputs (the op is per window,
    so the packed rows stand for both layouts); by default at the c16
    generator's canvas-256 shapes, for every plan of ATTENTION_PLANS (or
    those named in ``plans``)."""
    rng = np.random.default_rng(smoke.SEED)
    out = {}
    shapes = shapes or list(dict.fromkeys(
        s for _, s in smoke.attention_shapes(smoke.CANVASES[0])))
    for shape in shapes:
        C = shape[-1]
        for label, x, ws in smoke.attention_stress_inputs(rng, shape,
                                                             packed=True):
            rows = torch.from_numpy(x).to(BF16).reshape(-1, 16, C)
            ws = [torch.from_numpy(w.astype(np.float32)).to(BF16) for w in ws]
            chunk = max(1, ROWS_CHUNK * 256 // max(C, 256))   # ~1 GB a tensor
            for i in range(0, rows.shape[0], chunk):
                t = rows[i:i + chunk]
                ref = window_rows_attention_plain(t, *ws).to(BF16)
                for name in plans or ATTENTION_PLANS:
                    plan = ATTENTION_PLANS[name] or attention_kernel_plan(C)
                    d, r = ratio(attention_chain(t, *ws, plan), ref)
                    pd, pr = out.get((shape, label, name), (0.0, 0.0))
                    out[(shape, label, name)] = (max(d, pd), max(r, pr))
    return out


def block_ratios(shapes=((smoke.BATCH, 64, 64, 64), (2, 12, 20, 64)),
                 plans=None):
    """The same for the block chain on ``chip_smoke.block_stress_inputs``."""
    rng = np.random.default_rng(smoke.SEED)
    out = {}
    for shape in shapes:
        for label, host, weights in smoke.block_stress_inputs(rng, shape):
            t = lambda a, dt=BF16: torch.from_numpy(
                np.asarray(a, np.float32)).to(dt)
            args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                    t(host[3], torch.float32))
            kw = {n: t(a) for n, a in weights.items()}
            ref = structural_block_plain(*args, **kw)
            for name in plans or BLOCK_PLANS:
                plan = BLOCK_PLANS[name] or block_kernel_plan(shape[-1])
                out[(shape, label, name)] = ratio(
                    block_chain(*args, plan, **kw), ref)
    return out


def block_exactness(x, struct, gamma, beta, dtype, scores, ln1=None, *,
                    norm1_w, norm1_b, qkv_w, qkv_b, proj_w, proj_b, norm2_w,
                    norm2_b, fc1_w, fc1_b, fc2_w, fc2_b, eps=1e-5):
    """The block body on an 8x8-multiple grid carried in ``dtype``, with
    the qkv product, the scores and the softmax in ``scores`` and LN1 with
    the FiLM in ``ln1`` (``dtype`` by default; the fp32 question: where
    fp32 loses what float64 keeps); returns float64."""
    B, H, W, C = x.shape
    heads = default_num_heads(C)
    hd = C // heads
    f = lambda a, dt=dtype: a.to(dt)
    xf = f(x)
    g = lambda a: a.to(ln1 or dtype)
    h = F.layer_norm(g(xf + f(struct)), (C,), g(norm1_w), g(norm1_b), eps)
    h = h * (1.0 + g(gamma)[:, None, None, :]) + g(beta)[:, None, None, :]
    qkv = F.linear(f(h, scores), f(qkv_w, scores), f(qkv_b, scores))
    t = _windows(qkv).reshape(-1, WINDOW * WINDOW, 3, heads, hd)
    q, k, v = t.permute(2, 0, 3, 1, 4)
    p = torch.softmax((q @ k.transpose(-2, -1)) / math.sqrt(hd), -1)
    o = _unwindows((f(p) @ f(v)).permute(0, 2, 1, 3).reshape(
        -1, WINDOW * WINDOW, C), B, H, W)
    xf = xf + F.linear(o, f(proj_w), f(proj_b))
    h2 = F.layer_norm(xf, (C,), f(norm2_w), f(norm2_b), eps)
    a = F.gelu(F.linear(h2, f(fc1_w), f(fc1_b)))
    return (xf + F.linear(a, f(fc2_w), f(fc2_b))).double()


def fp32_block_question() -> int:
    """How far an fp32 evaluation of the block lies from a float64 one on
    ``chip_smoke.block_stress_inputs``, with the qkv product, scores and
    softmax in fp32 and in float64 (as the fp32 dim-256 kernel carries
    them), and with LN1 and the FiLM in float64 too (as the plain version
    and the fp32 kernel past dim 256 carry them), against the fp32
    tolerance ``BLOCK_FP32_TOL``; at dims 128, 256 and 512 (batch 2 at
    dim 512)."""
    rng = np.random.default_rng(smoke.SEED)
    f32, f64 = torch.float32, torch.float64
    for shape in ((smoke.BATCH, 64, 64, 128), (smoke.BATCH, 64, 64, 256),
                  (2, 64, 64, 512)):
        for label, host, weights in smoke.block_stress_inputs(rng, shape):
            t = lambda a: torch.from_numpy(np.asarray(a, np.float64))
            args = [t(a) for a in host]
            kw = {n: t(a) for n, a in weights.items()}
            exact = block_exactness(*args, f64, f64, **kw)
            for scores, ln1 in ((f32, None), (f64, None), (f64, f64)):
                d = (block_exactness(*args, f32, scores, ln1, **kw)
                     - exact).abs()
                print(f"block fp32 {shape} {label}, qkv and scores in "
                      f"{str(scores)[6:]}, LN1 in {str(ln1 or f32)[6:]}: "
                      f"max|d| from float64 "
                      f"{d.max().item():.3e} (x{d.max().item() / smoke.BLOCK_FP32_TOL:.2f}"
                      f" of the fp32 tolerance)", flush=True)
    return 0


def main(argv=None) -> int:
    import sys

    torch.set_num_threads(4)
    if "--fp32" in (sys.argv[1:] if argv is None else argv):
        return fp32_block_question()
    canvas = smoke.CANVASES[0]
    args = sys.argv[1:] if argv is None else argv
    grid = "--grid" in args or "--any" in args
    widths = (smoke.ANY_KERNEL_CHANNELS if "--any" in args
              else smoke.GRID_CHANNELS if grid else smoke.GENERATOR_CHANNELS)
    attention = list(dict.fromkeys(
        s for c in widths for _, s in smoke.attention_shapes(canvas, c)))
    block = [s for c in widths
             for s in ((smoke.BATCH, canvas // 4, canvas // 4, 4 * c),
                       (2, 12, 20, 4 * c))]
    plans = None
    if grid:   # and each width's down2 at canvas 512
        attention += [dict(smoke.attention_shapes(smoke.CANVASES[1], c))[
            "down2"] for c in widths]
        block += [(smoke.BATCH, smoke.CANVASES[1] // 4,
                   smoke.CANVASES[1] // 4, 4 * c) for c in widths]
        plans = ["kernel"]
    if "--any" in args:   # dims up to 32 run in the FMA bodies: no pairs
        block = [b for b in block if b[-1] > 32]
    block_plans = None
    if "--past128" in args:
        widths = smoke.PAST_SERVED_CHANNELS
        attention = [dict(smoke.attention_shapes(canvas, c))["down2"]
                     for c in widths]
        # and the chain's widest heads and dims (c268, c508, c512) on a
        # small grid, with the pairs' plan beside the kernel's
        block = [s for c in widths
                 for s in ((smoke.BATCH, canvas // 4, canvas // 4, 4 * c),
                           (2, 12, 20, 4 * c))] + [
            (2, 32, 32, d) for d in (1072, 2032, 2048)]
        plans = ["kernel"]
        block_plans = ["kernel", "every operand a pair"]
    if "--wide" in args:
        widths = smoke.WIDE_FULL_CHANNELS + smoke.WIDE_SMALL_CHANNELS
        attention = [dict(smoke.attention_shapes(canvas, c))["down2"]
                     for c in widths]
        block = [s for c in widths
                 for s in ((smoke.BATCH, canvas // 4, canvas // 4, 4 * c),
                           (2, 12, 20, 4 * c))]
        plans = ["kernel"]

    for kernel, ratios in (("attention", attention_ratios(attention, plans)),
                           ("block", block_ratios(block,
                                                  block_plans or plans))):
        for (shape, label, plan), (d, r) in ratios.items():
            print(f"{kernel} {shape} {label}, {plan}: max|d| {d:.3e} "
                  f"(x{r:.3f} of the bound)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
