"""Where the training kernels may round to bf16: an emulation on the CPU.

    PYTHONPATH=. python3 devtools/train_kernel_rounding.py [--widths]
    PYTHONPATH=. python3 devtools/train_kernel_rounding.py --fp32 [--draws N]

The tensor-core kernels of the channel-attention mid
(``csrc/window_attention_train.cu``) and the window-MHSA mid
(``csrc/window_mhsa_train.cu``) feed operands they form themselves (qn, kn,
S, dL; the exponentials, p, ds) to bf16 matrix products with fp32 sums.
This script repeats their arithmetic in PyTorch with those operands
rounded to bf16, either as one term or as a hi + lo pair (hi = bf16(x), lo
= bf16(x - hi); the products hi hi + hi lo + lo hi), and holds the result
against the plain versions at ``chip_smoke.py``'s bound (``BF16_ATOL``,
``BF16_RTOL``) at every train shape on ``chip_smoke.train_kernel_inputs``
(random, saturated softmax, small q and k). For each rounding plan it
prints the largest |d| and its ratio to the bound ("x1.000" is at the
bound); ``kernel`` is the plan the kernels use. Takes about a minute.
``--widths`` runs the shapes of the c8, c32 and c64 generators instead
(``chip_smoke.width_train_kernel_cases``: the mid at C = 8 to 64, the MHSA
at 1, 4 and 8 heads; C = 8 runs padded to 16 in the kernel, whose pads add
exact zeros to every sum, so it is emulated as it is); a few minutes. At 8
heads, (8, 64, 64, 768), the kernel plan holds the saturated input at 0.57
(forward) and 0.85 (backward) of the bound. ``--grid`` runs the c24, c40,
c48 and c56 generators' (``chip_smoke.GRID_CHANNELS``: the MHSA at 3, 5, 6
and 7 heads; their LocalAttention widths train through the fast-VJP route,
not these kernels).

``--any`` runs the widths of ``chip_smoke.ANY_KERNEL_CHANNELS`` (the mid
at C = 1, 2, 4, padded to 16 in the kernel; the MHSA at the heads of 4 ..
62 channels of dims 4 .. 252, each in a slot of its width rounded up to
16, whose pads add exact zeros, so it is emulated at the real width and
scale).

``--fp32`` asks the fp32 question instead: on the "small q, k" input of
the channel-attention mid, how far an fp32 evaluation of the backward (the
formulas in fp32, in PyTorch's order) lies from a float64 one, against
the fp32 tolerance ``TRAIN_GRAD_FP32_TOL``, over ``--draws`` draws at the
up2 shape of each width (C = 8, 16, 32, at 64^2: the one small window is
what matters), with the largest gradient and the fp32 spacing at it.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

import chip_smoke as smoke

WA = importlib.import_module(
    "multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention_train")
WM = importlib.import_module(
    "multi_style_transfer_gan_tpu_torch.ops.kernels.window_mhsa_train")
BF16 = torch.bfloat16

# operand -> split into hi + lo (True) or one bf16 term (False); for the
# channel attention S is the softmax in dv = dO S and Sout the same in out =
# v S^T, and the kernel's plan depends on C (kernel_plan)
PLANS = {
    "attention": {"all one term": dict(qk=False, S=False, Sout=False, dL=False),
                  "dL split": dict(qk=False, S=False, Sout=False, dL=True),
                  "kernel": None},
    "mhsa": {"all one term": dict(P=False, dS=False),
             "ds split": dict(P=False, dS=True),
             "kernel": dict(P=True, dS=True)},
}


def _parts(x, split):
    """x as bf16 terms: (hi, lo) for a pair (``split`` True), (hi, None) for
    one term; ``"fp32"`` keeps x as it is (an operand the kernel keeps in
    fp32), 3 three terms (hi + mid, exact in fp32, and lo)."""
    if split == "fp32":
        return x, None
    hi = x.to(BF16).float()
    if split == 3:
        mid = (x - hi).to(BF16).float()
        return hi + mid, (x - hi - mid).to(BF16).float()
    return hi, ((x - hi).to(BF16).float() if split else None)


def mm(a, b, split_a, split_b):
    """a @ b with bf16 operands (each one term or hi + lo), fp32 sums."""
    ah, al = _parts(a, split_a)
    bh, bl = _parts(b, split_b)
    out = ah @ bh
    if bl is not None:
        out = out + ah @ bl
    if al is not None:
        out = out + al @ bh
    return out


def mhsa(qkv, d_out, plan, heads=2):
    """The MHSA kernel's arithmetic: exponentials e = exp(s - max) enter
    o = e v (divided by the row sum after), ds enters dq and dk, p enters
    dv; q, k, v, dO are the bf16 inputs."""
    B, H, W, _ = qkv.shape
    q, k, v = WM._qkv_heads(qkv, heads)
    do = WM._split_heads(d_out, heads)
    scale = q.shape[-1] ** -0.5
    s = (q @ k.transpose(-2, -1)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    rows = e.sum(-1, keepdim=True)
    out = WM._merge_heads(mm(e, v, plan["P"], False) / rows, B, H, W)
    p = e / rows
    dp = do @ v.transpose(-2, -1)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = mm(ds, k, plan["dS"], False) * scale
    dk = mm(ds.transpose(-2, -1), q, plan["dS"], False) * scale
    dv = mm(p.transpose(-2, -1), do, False, False)
    dqkv = torch.cat([WM._merge_heads(t, B, H, W) for t in (dq, dk, dv)], -1)
    return out.to(qkv.dtype), dqkv.to(qkv.dtype)


def kernel_plan(C):
    """The channel-attention kernels' plan at width C: qn, kn and dL as
    pairs; S as one term, but as a pair in out = v S^T at C = 8, where one
    term misses the bound on the saturated input (8 keys, S ~ 1/8 each)."""
    return dict(qk=True, S=False, Sout=C < 16, dL=True)


def attention(qkv, d_out, plan, eps=1e-12):
    """The channel-attention kernel's arithmetic: qn, kn enter the Gram,
    dqn and dkn; S enters out and dv; dL enters dqn and dkn; the normalize
    and its backward are fp32."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    plan = plan or kernel_plan(C)
    q, k, v = WA.window_partition(qkv.float(), WA.WINDOW).split(C, dim=-1)
    qn, inv_q, sel_q = WA._normalize(q, eps)
    kn, inv_k, sel_k = WA._normalize(k, eps)
    s = torch.softmax(mm(qn.transpose(1, 2), kn, plan["qk"], plan["qk"]), -1)
    out = mm(v, s.transpose(1, 2), False, plan["Sout"])
    do = WA.window_partition(d_out.float(), WA.WINDOW)
    ds = do.transpose(1, 2) @ v
    dl = s * (ds - (s * ds).sum(-1, keepdim=True))
    dv = mm(do, s, False, plan["S"])
    dqn = mm(kn, dl.transpose(1, 2), plan["qk"], plan["dL"])
    dkn = mm(qn, dl, plan["qk"], plan["dL"])
    dq = (dqn - qn * (qn * dqn).sum(-1, keepdim=True) * sel_q) * inv_q
    dk = (dkn - kn * (kn * dkn).sum(-1, keepdim=True) * sel_k) * inv_k
    merge = lambda t: WA.window_merge(t, B, H, W, WA.WINDOW).to(qkv.dtype)
    return merge(out), merge(torch.cat([dq, dk, dv], -1))


def ratio(got, ref):
    """(max |d|, max |d| / (BF16_ATOL + BF16_RTOL |ref|))."""
    d = (got.float() - ref.float()).abs()
    bound = smoke.BF16_ATOL + smoke.BF16_RTOL * ref.float().abs()
    return d.max().item(), (d / bound).max().item()


def fp32_backward(qkv, d_out, dtype, eps=1e-12):
    """The plain backward's formulas carried in ``dtype`` (float32 or
    float64), returned in float64."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    q, k, v = WA.window_partition(qkv.to(dtype), WA.WINDOW).split(C, dim=-1)
    qn, inv_q, sel_q = WA._normalize(q, eps)
    kn, inv_k, sel_k = WA._normalize(k, eps)
    s = torch.softmax(qn.transpose(1, 2) @ kn, dim=-1)
    do = WA.window_partition(d_out.to(dtype), WA.WINDOW)
    ds = do.transpose(1, 2) @ v
    dl = s * (ds - (s * ds).sum(-1, keepdim=True))
    dqn, dkn = kn @ dl.transpose(1, 2), qn @ dl
    dq = (dqn - qn * (qn * dqn).sum(-1, keepdim=True) * sel_q) * inv_q
    dk = (dkn - kn * (kn * dkn).sum(-1, keepdim=True) * sel_k) * inv_k
    out = torch.cat([dq, dk, do @ s], -1)
    return WA.window_merge(out, B, H, W, WA.WINDOW).double()


def fp32_question(draws: int) -> int:
    for C in (8, 16, 32):
        worst = top = 0.0
        for seed in range(draws):
            rng = np.random.default_rng(seed)
            host = dict((label, (q, g)) for label, q, g in
                        smoke.train_kernel_inputs(rng, "attention",
                                                  (2, 64, 64, 3 * C)))
            qkv, g = (torch.from_numpy(a) for a in host["small q, k"])
            exact = fp32_backward(qkv, g, torch.float64)
            d = (fp32_backward(qkv, g, torch.float32) - exact).abs().max()
            worst, top = max(worst, d.item()), max(top, exact.abs().max().item())
        print(f"attention C = {C}, small q, k, {draws} draws: fp32 vs float64 "
              f"max|d| {worst:.3e} (x{worst / smoke.TRAIN_GRAD_FP32_TOL:.2f} of "
              f"the fp32 tolerance {smoke.TRAIN_GRAD_FP32_TOL}); largest "
              f"gradient {top:.1f}, fp32 spacing there "
              f"{np.spacing(np.float32(top)):.3e}", flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--widths", action="store_true")
    p.add_argument("--grid", action="store_true")
    p.add_argument("--any", action="store_true")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--draws", type=int, default=8)
    args = p.parse_args(argv)
    torch.set_num_threads(4)
    if args.fp32:
        return fp32_question(args.draws)
    rng = np.random.default_rng(smoke.SEED)
    emulate = {"attention": attention, "mhsa": mhsa}
    plain = {"attention": (WA.window_attention_mid_plain,
                           WA.window_attention_mid_backward_plain),
             "mhsa": (WM.window_mhsa_plain, WM.window_mhsa_backward_plain)}
    if args.widths or args.grid or args.any:
        widths = (smoke.ANY_KERNEL_CHANNELS if args.any
                  else smoke.GRID_CHANNELS if args.grid
                  else smoke.WIDTH_CHANNELS + smoke.C64_CHANNELS)
        cases = [case for c in widths
                 for case in smoke.width_train_kernel_cases(c)]
    else:
        cases = [(name, stage, shape, 2 if name == "mhsa" else None)
                 for name, stage, shape in smoke.train_kernel_cases()]
    for name, stage, shape, heads in cases:
        fwd, bwd = plain[name]
        extra = () if heads is None else (heads,)
        for label, host, g in smoke.train_kernel_inputs(rng, name, shape):
            qkv = torch.from_numpy(host).to(BF16)
            d_out = torch.from_numpy(g).to(BF16)
            ref = fwd(qkv, *extra), bwd(qkv, d_out, *extra)
            for plan_name, plan in PLANS[name].items():
                got = emulate[name](qkv, d_out, plan, *extra)
                (fd, fr), (bd, br) = ratio(got[0], ref[0]), ratio(got[1], ref[1])
                print(f"{name} {stage} {shape}"
                      + ("" if heads is None else f" {heads} heads")
                      + f" {label}, {plan_name}: fwd max|d| {fd:.3e} (x{fr:.3f} "
                      f"of the bound), bwd max|d| {bd:.3e} (x{br:.3f})",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
