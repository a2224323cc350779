"""Windowed channel attention (LocalAttention): CUDA kernel and plain version.

``window_channel_attention`` is the op the JAX package computes with three
Pallas layouts (v1, grouped, v3, dispatched by
``ops/pallas/attention_dispatch.py``) and three more forms of the same
math (``window_attention_v4``, ``window_attention_v3_fused_io`` and the A/B
script's ``window_attention_v6``); on Hopper one source,
``csrc/window_channel_attention.cu``, takes any C (``kernel_takes``): up to
512 (the LocalAttention widths C, 2C and 4C of every generator width from 1
to 128) one kernel, each C run inside the built layout of the next power of
two (``layout_width``), a width whose rows are not 16-byte aligned (C % 8 !=
0) moved 8 bytes at a time (C % 4 == 0) or a value at a time; past 512 (2C
and 4C of every generator from c129 on) the op streams over channels
through an fp32 workspace the wrapper allocates (``attention_workspace``):
the qkv product, the norms with the Gram, softmax and apply, and the proj,
in chunks of ``stream_windows`` windows.
``window_channel_attention_plain`` is the port of
``_attention_math`` / ``_attention_windows``
(models/enhanced_generator.py:168-205).

``window_channel_attention_stage`` runs a prefix of the same kernel body
(``STAGES``: copy, qkv, norm, logits, softmax, full), the counterpart of the
TPU stage ablation ``scripts/ab_v3_ablation.py::run_stage``; it is a
measuring instrument (``tools/attention_ablation.py``), not a path of the
model.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...core.norm import l2_normalize
from . import _build
from ._checks import check_cuda_args, check_no_grad, dtype_code

WINDOW = 4
STAGE_WIDTHS = (16, 32, 64)            # the stage ablation's (c16's)
STAGES = ("copy", "qkv", "norm", "logits", "softmax", "full")
# the widest C one block's layout holds; past it the op streams
STREAM_FROM = 512
# the bytes of fp32 workspace a streamed call holds at most (q, k, v and
# the output of 16 positions a window: 256 C bytes a window), at least one
# window
WORKSPACE_BYTES = 256 * 2 ** 20


def kernel_takes(C: int) -> bool:
    """The attention kernel's widths: any C >= 1 (C % 8 != 0 in the
    runtime-C variant of its layout, with narrower moves; C > 512 streamed
    through a workspace)."""
    return C >= 1


def stream_windows(n_windows: int, C: int) -> int:
    """The windows a streamed call's workspace holds (0 at C <= 512, which
    takes none): at most ``WORKSPACE_BYTES`` of it, at least one window,
    no more than the call has."""
    if C <= STREAM_FROM:
        return 0
    return max(1, min(n_windows, WORKSPACE_BYTES // (256 * C)))


def attention_workspace(n_windows: int, C: int, device) -> tuple:
    """(workspace tensor or None, its windows) of one call on ``n_windows``
    windows at width C: 64 C fp32 values a window past C = 512."""
    n = stream_windows(n_windows, C)
    return (torch.empty(n * 64 * C, device=device) if n else None), n


def layout_width(C: int, bf16: bool) -> int:
    """CP, the channels of the built layout a tensor of C channels runs in
    (zeros in the channels C..CP): the next power of two from 16 in bf16
    (m16n8k16 takes 16-deep k-steps), from 8 in fp32."""
    cp = 16 if bf16 else 8
    while cp < C:
        cp *= 2
    return cp


def persistent_grid(n_units: int, sms: int, blocks_per_sm: int) -> int:
    """The grid of a persistent kernel whose blocks stride over ``n_units``
    units of work, as ``csrc/common.cuh::persistent_grid`` computes it: one
    block per unit until the card is full (``blocks_per_sm`` resident
    blocks on each of ``sms`` SMs), never less than one block."""
    return max(1, min(n_units, sms * blocks_per_sm))


def attention_launch_shape(n_windows: int, C: int, bf16: bool) -> tuple:
    """(units of work, dynamic shared memory in bytes) of one launch of the
    attention kernel at width C, as ``csrc/window_channel_attention.cuh``
    lays it out in the layout of CP = ``layout_width(C, bf16)`` channels.
    bf16 (warp MMA): a unit is one window per warp of the block's 8 (3 at
    CP = 128); the block holds the bf16 weights in rows of CP + 8, per warp
    two x buffers (16 x (CP + 8)) and qn | kn as hi and lo (16 x (2CP + 8)
    each), then 4CP fp32 biases and CP fp32 row sums a warp. CP = 256
    (bf16): a unit is two windows; the block holds two weight tiles of 64
    rows of CP + 8, the two windows' x (later out hi), out lo, q | k hi and
    lo (rows of 2CP + 8) and v hi and lo, then 4CP fp32 biases. CP = 512
    (bf16): the same with one window a unit and weight tiles of 64 rows of
    half the width (CP / 2 + 8). fp32 (FMA): a unit is a tile of 64 / CP
    windows (one at CP >= 128); everything is fp32, the weights are staged
    too up to CP = 64, and the Gram is held 64 rows at a time at CP = 256,
    32 at CP = 512 (512 threads). Past C = 512 the op streams: this is the
    mid's launch (``csrc/window_channel_attention_stream.cuh``), a block a
    window and strip of query channels (128 in bf16, 64 in fp32) with
    static shared memory only."""
    if C > STREAM_FROM:
        strip = 128 if bf16 else 64
        return n_windows * -(-C // strip), 0
    cp = layout_width(C, bf16)
    if bf16 and cp > 128:
        windows = 1 if cp > 256 else 2
        rows, xs, ts = 16 * windows, cp + 8, (cp if cp <= 256 else cp // 2) + 8
        elems = 2 * 64 * ts + 4 * rows * xs + 2 * rows * (2 * cp + 8)
        return -(-n_windows // windows), 2 * elems + 4 * 4 * cp
    if bf16:
        warps = 3 if cp > 64 else 8
        warp = 2 * 16 * (cp + 8) + 2 * 16 * (2 * cp + 8)
        smem = 2 * (4 * cp * (cp + 8) + warps * warp) + 4 * (4 * cp + warps * cp)
        return -(-n_windows // warps), smem
    nw = max(1, 64 // cp)
    rows, qs, gs = nw * 16, 3 * cp + 1, cp + 1
    weights = cp * qs + cp * gs if cp <= 64 else 0
    strip = 32 if cp > 256 else 64 if cp > 128 else cp
    floats = (weights + 3 * cp + cp + rows * cp + rows * qs + 2 * rows
              + nw * strip * gs)
    return -(-n_windows // nw), 4 * floats


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
                     extra=(), takes=kernel_takes, built="any C >= 1"):
    """The CUDA path of the attention wrappers at width C: checks (C taken
    by ``takes``, described by ``built``), the launch of entry point
    ``wrapper.__name__`` with its grid ``dims`` (B, H, W of the NHWC tensor
    or of the packed one), the ``extra`` ints that follow C and, where the
    entry point takes one (a pointer after eps in ``_build.SIGNATURES``),
    the workspace of a streamed width, and ``wrapper.launches``."""
    entry = wrapper.__name__
    argtypes = _build.SIGNATURES[entry][2]
    streamed = argtypes[argtypes.index(ctypes.c_float) + 1] is ctypes.c_void_p
    check_no_grad(entry, x, wqkv, bqkv, wproj, bproj)
    if not takes(C):
        raise ValueError(f"{entry} kernel is built for {built}, got C={C}")
    wqkv = wqkv.reshape(3 * C, C)
    wproj = wproj.reshape(C, C)
    check_cuda_args(entry, x,
                    {"wqkv": (wqkv, (3 * C, C)), "bqkv": (bqkv, (3 * C,)),
                     "wproj": (wproj, (C, C)), "bproj": (bproj, (C,))})
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel():
        tail = ()
        if streamed:
            n_windows = x.numel() // (C * WINDOW * WINDOW)
            ws, n = attention_workspace(n_windows, C, x.device)
            tail = (None if ws is None else ws.data_ptr(), n)
        rc = _build.kernel(entry)(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
            bproj.data_ptr(), y.data_ptr(), *dims, C, *extra, dtype_code(x),
            eps, *tail, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
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
    (contiguous fp32 or bf16 input, weights of the same type,
    ``kernel_takes(C)``, H % 4 == W % 4 == 0) or raises. The kernel is
    forward-only: a CUDA call that autograd would record raises (the
    training route is ``window_channel_attention_train`` between the two
    1x1 convs).
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
    (B, H, W, C) tensor, C in ``STAGE_WIDTHS``: the stage-ablation
    instrument.

    A CPU tensor takes the plain version; a CUDA tensor launches the stage
    kernel (``csrc/window_attention_stages.cu``) or raises, with the checks
    of ``window_channel_attention``. An unknown stage or a width the kernel
    is not built for raises on either device.
    """
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    B, H, W, C = x.shape
    if C not in STAGE_WIDTHS:
        raise ValueError(f"window_channel_attention_stage kernel is built "
                         f"for C in {STAGE_WIDTHS}, got C={C}")
    _check_grid(H, W)
    if x.device.type == "cpu":
        return window_channel_attention_stage_plain(
            x, wqkv, bqkv, wproj, bproj, stage=stage, eps=eps)
    return launch_attention(window_channel_attention_stage, x, wqkv, bqkv,
                            wproj, bproj, C, (B, H, W), eps,
                            extra=(STAGES.index(stage),),
                            takes=STAGE_WIDTHS.__contains__,
                            built=f"C in {STAGE_WIDTHS}")


window_channel_attention_stage.launches = 0
