"""Where the training kernels may round to bf16: an emulation on the CPU.

    PYTHONPATH=. python3 devtools/train_kernel_rounding.py

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

# operand -> split into hi + lo (True) or one bf16 term (False)
PLANS = {
    "attention": {"all one term": dict(qk=False, S=False, dL=False),
                  "dL split": dict(qk=False, S=False, dL=True),
                  "kernel": dict(qk=True, S=False, dL=True)},
    "mhsa": {"all one term": dict(P=False, dS=False),
             "ds split": dict(P=False, dS=True),
             "kernel": dict(P=True, dS=True)},
}


def _parts(x, split):
    hi = x.to(BF16).float()
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


def mhsa(qkv, d_out, plan):
    """The MHSA kernel's arithmetic: exponentials e = exp(s - max) enter
    o = e v (divided by the row sum after), ds enters dq and dk, p enters
    dv; q, k, v, dO are the bf16 inputs."""
    B, H, W, _ = qkv.shape
    q, k, v = WM._qkv_heads(qkv, 2)
    do = WM._split_heads(d_out, 2)
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


def attention(qkv, d_out, plan, eps=1e-12):
    """The channel-attention kernel's arithmetic: qn, kn enter the Gram,
    dqn and dkn; S enters out and dv; dL enters dqn and dkn; the normalize
    and its backward are fp32."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    q, k, v = WA.window_partition(qkv.float(), WA.WINDOW).split(C, dim=-1)
    qn, inv_q, sel_q = WA._normalize(q, eps)
    kn, inv_k, sel_k = WA._normalize(k, eps)
    s = torch.softmax(mm(qn.transpose(1, 2), kn, plan["qk"], plan["qk"]), -1)
    out = mm(v, s.transpose(1, 2), False, plan["S"])
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


def main() -> int:
    torch.set_num_threads(4)
    rng = np.random.default_rng(smoke.SEED)
    emulate = {"attention": attention, "mhsa": mhsa}
    plain = {"attention": (WA.window_attention_mid_plain,
                           WA.window_attention_mid_backward_plain, ()),
             "mhsa": (WM.window_mhsa_plain, WM.window_mhsa_backward_plain,
                      (2,))}
    for name, stage, shape in smoke.train_kernel_cases():
        fwd, bwd, extra = plain[name]
        for label, host, g in smoke.train_kernel_inputs(rng, name, shape):
            qkv = torch.from_numpy(host).to(BF16)
            d_out = torch.from_numpy(g).to(BF16)
            ref = fwd(qkv, *extra), bwd(qkv, d_out, *extra)
            for plan_name, plan in PLANS[name].items():
                got = emulate[name](qkv, d_out, plan)
                (fd, fr), (bd, br) = ratio(got[0], ref[0]), ratio(got[1], ref[1])
                print(f"{name} {stage} {shape} {label}, {plan_name}: fwd max|d| "
                      f"{fd:.3e} (x{fr:.3f} of the bound), bwd max|d| {bd:.3e} "
                      f"(x{br:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
