"""Windowed channel attention (LocalAttention): CUDA kernel and plain version.

``window_channel_attention`` is the op the JAX package computes with three
Pallas layouts (v1, grouped, v3, dispatched by
``ops/pallas/attention_dispatch.py``) and three more forms of the same
math (``window_attention_v4``, ``window_attention_v3_fused_io`` and the A/B
script's ``window_attention_v6``); on Hopper one kernel,
``csrc/window_channel_attention.cu``, serves every width the generator has
(C = 16, 32, 64). ``window_channel_attention_plain`` is the port of
``_attention_math`` / ``_attention_windows``
(models/enhanced_generator.py:168-205).

``window_channel_attention_stage`` runs a prefix of the same kernel body
(``STAGES``: copy, qkv, norm, logits, softmax, full), the counterpart of the
TPU stage ablation ``scripts/ab_v3_ablation.py::run_stage``; it is a
measuring instrument (``tools/attention_ablation.py``), not a path of the
model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.norm import l2_normalize
from . import _build
from ._checks import check_cuda_args, check_no_grad, dtype_code

WINDOW = 4
KERNEL_WIDTHS = (16, 32, 64)
STAGES = ("copy", "qkv", "norm", "logits", "softmax", "full")


def window_rows_attention_plain(t, wqkv, bqkv, wproj, bproj, *,
                                eps: float = 1e-12) -> torch.Tensor:
    """The op on (R, 16, C) windows, 16 positions each, in fp32: qkv,
    zero-safe L2 normalize of q and k over C, the C x C Gram softmax,
    applied to v, proj. Weights in the PyTorch (out, in) layout."""
    C = t.shape[-1]
    qkv = F.linear(t.float(), wqkv.reshape(3 * C, C).float(), bqkv.float())
    q, k, v = qkv.split(C, dim=-1)
    # attn[c1, c2] = sum_t qn[t, c1] kn[t, c2]
    attn = torch.softmax(l2_normalize(q, eps).transpose(1, 2)
                         @ l2_normalize(k, eps), dim=-1)
    out = v @ attn.transpose(1, 2)   # out[t, c1] = sum_c2 attn[c1, c2] v[t, c2]
    return F.linear(out, wproj.reshape(C, C).float(), bproj.float())


def window_rows_stage_plain(t, wqkv, bqkv, wproj, bproj, *, stage: str,
                            eps: float = 1e-12) -> torch.Tensor:
    """Stage ``stage`` of the op on (R, 16, C) windows, in fp32: what the
    stage kernel stores at position p, channel c of each window.

    copy: x; qkv: q + k + v; norm: qn + kn + v; logits: v plus, at
    position p < min(C, 16), the sum of row p of the Gram G = qn^T kn;
    softmax: the same fold over softmax_rows(G); full: the op
    (``window_rows_attention_plain``). At C = 16 this is what the TPU
    ablation's ``run_stage`` computes; its 0/1-matrix fold of logits and
    softmax builds only for C <= 16, and at C = 32 and 64 the port keeps
    the same rule.
    """
    if stage == "full":
        return window_rows_attention_plain(t, wqkv, bqkv, wproj, bproj, eps=eps)
    if stage == "copy":
        return t.float()
    C = t.shape[-1]
    qkv = F.linear(t.float(), wqkv.reshape(3 * C, C).float(), bqkv.float())
    q, k, v = qkv.split(C, dim=-1)
    if stage == "qkv":
        return q + k + v
    qn, kn = l2_normalize(q, eps), l2_normalize(k, eps)
    if stage == "norm":
        return qn + kn + v
    gram = qn.transpose(1, 2) @ kn
    if stage == "softmax":
        gram = torch.softmax(gram, dim=-1)
    n = min(C, WINDOW * WINDOW)
    fold = torch.zeros(t.shape[:2], dtype=v.dtype, device=v.device)
    fold[:, :n] = gram.sum(dim=-1)[:, :n]
    return v + fold[..., None]


def _windowed(rows_fn, x, *args, **kw) -> torch.Tensor:
    """``rows_fn`` on the 4x4 windows of NHWC ``x`` as (R, 16, C) rows,
    laid back out as (B, H, W, C) in x's type."""
    B, H, W, C = x.shape
    ws = WINDOW
    nh, nw = H // ws, W // ws
    t = x.reshape(B, nh, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5)
    out = rows_fn(t.reshape(-1, ws * ws, C), *args, **kw)
    out = out.reshape(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(B, H, W, C).to(x.dtype)


def window_channel_attention_plain(x, wqkv, bqkv, wproj, bproj, *,
                                   eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version. x: (B, H, W, C); wqkv (3C, C[, 1, 1]), bqkv
    (3C,), wproj (C, C[, 1, 1]), bproj (C,) in the PyTorch (out, in) layout.

    Computes in fp32 whatever the input type and rounds once at the end,
    as the kernel does, so the two agree to fp32 rounding in fp32 and to
    one output rounding in bf16.
    """
    return _windowed(window_rows_attention_plain, x, wqkv, bqkv, wproj,
                     bproj, eps=eps)


def window_channel_attention_stage_plain(x, wqkv, bqkv, wproj, bproj, *,
                                         stage: str,
                                         eps: float = 1e-12) -> torch.Tensor:
    """Plain version of stage ``stage`` (``window_rows_stage_plain``) on a
    (B, H, W, C) tensor, computed in fp32 and rounded once to x's type;
    ``stage="full"`` is ``window_channel_attention_plain``."""
    return _windowed(window_rows_stage_plain, x, wqkv, bqkv, wproj, bproj,
                     stage=stage, eps=eps)


def launch_attention(wrapper, x, wqkv, bqkv, wproj, bproj, C, dims, eps,
                     extra=()):
    """The CUDA path of the attention wrappers at width C: checks, the
    launch of entry point ``wrapper.__name__`` with its grid ``dims`` (B,
    H, W of the NHWC tensor or of the packed one) and the ``extra`` ints
    that follow C, and ``wrapper.launches``."""
    entry = wrapper.__name__
    check_no_grad(entry, x, wqkv, bqkv, wproj, bproj)
    if C not in KERNEL_WIDTHS:
        raise ValueError(f"{entry} kernel is built for C in {KERNEL_WIDTHS}, "
                         f"got C={C}")
    wqkv = wqkv.reshape(3 * C, C)
    wproj = wproj.reshape(C, C)
    check_cuda_args(entry, x,
                    {"wqkv": (wqkv, (3 * C, C)), "bqkv": (bqkv, (3 * C,)),
                     "wproj": (wproj, (C, C)), "bproj": (bproj, (C,))})
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel():
        rc = _build.kernel(entry)(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
            bproj.data_ptr(), y.data_ptr(), *dims, C, *extra, dtype_code(x),
            eps, x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
        wrapper.launches += 1
    return y


def _check_grid(H, W):
    if H % WINDOW or W % WINDOW:
        raise ValueError(f"window attention needs H and W divisible by "
                         f"{WINDOW}, got {H}x{W}")


def window_channel_attention(x, wqkv, bqkv, wproj, bproj, *,
                             eps: float = 1e-12) -> torch.Tensor:
    """LocalAttention forward on a (B, H, W, C) tensor, 4x4 windows.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (contiguous fp32 or bf16 input, weights of the same type, C in 16/32/64,
    H % 4 == W % 4 == 0) or raises. The kernel is forward-only: a CUDA call
    that autograd would record raises (the training route is
    ``window_channel_attention_train`` between the two 1x1 convs).
    """
    B, H, W, C = x.shape
    _check_grid(H, W)
    if x.device.type == "cpu":
        return window_channel_attention_plain(x, wqkv, bqkv, wproj, bproj,
                                              eps=eps)
    return launch_attention(window_channel_attention, x, wqkv, bqkv, wproj,
                            bproj, C, (B, H, W), eps)


window_channel_attention.launches = 0


def window_channel_attention_stage(x, wqkv, bqkv, wproj, bproj, *,
                                   stage: str,
                                   eps: float = 1e-12) -> torch.Tensor:
    """Stage ``stage`` (one of ``STAGES``) of the LocalAttention kernel on a
    (B, H, W, C) tensor, C in 16/32/64: the stage-ablation instrument.

    A CPU tensor takes the plain version; a CUDA tensor launches the stage
    kernel (``csrc/window_attention_stages.cu``) or raises, with the checks
    of ``window_channel_attention``. An unknown stage or a width the kernel
    is not built for raises on either device.
    """
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    B, H, W, C = x.shape
    if C not in KERNEL_WIDTHS:
        raise ValueError(f"window_channel_attention_stage kernel is built "
                         f"for C in {KERNEL_WIDTHS}, got C={C}")
    _check_grid(H, W)
    if x.device.type == "cpu":
        return window_channel_attention_stage_plain(
            x, wqkv, bqkv, wproj, bproj, stage=stage, eps=eps)
    return launch_attention(window_channel_attention_stage, x, wqkv, bqkv,
                            wproj, bproj, C, (B, H, W), eps,
                            extra=(STAGES.index(stage),))


window_channel_attention_stage.launches = 0
