"""StructuralTransformerBlock body: CUDA kernel and plain version.

``fused_structural_block`` replaces ``ops/pallas/fused_transformer.py``;
its kernels are ``csrc/fused_structural_block.cu`` (and, for bf16 past dim
256, ``csrc/fused_structural_block_pair.cu`` and
``csrc/fused_structural_block_stream.cu``), which take any dim in bf16
and in fp32 any dim whose ``default_num_heads`` heads are at most
``FP32_MAX_HEAD`` channels wide (``kernel_takes``): the blocks of every
generator width up to c712. Dims %
32 == 0 (heads of 32) up to 256 run in the tensor-core
designs: in bf16 dim 96 padded in the dim-128 design and dims 160-224 in
the dim-256 design. Every other generator dim from 48 on (heads of 36 to
56 channels) runs in bf16 in the head-slot kernel
(``fused_structural_block_slot_kernel``: each head in a slot of its width
rounded up to 16, ``slot_takes``), and in fp32 in the FMA bodies
(``fused_structural_block_any_kernel``), which also take, in both types,
c4's dim 16 and the dims no generator has (C % 4 != 0, odd heads). The
dims from 260 on run in bf16 in the pair kernel
(``fused_structural_block_pair_kernel``: a cluster of two blocks a window,
each on 32 tokens, exchanging each head's k and v through distributed
shared memory, heads in slots as in the slot kernel), and in fp32 in the
FMA bodies with the window's residual stream and LN output in a workspace
the wrapper allocates (``block_workspace_windows``). The bf16 dims the
one-window designs do not hold (past 512, or heads wider than 64:
``stream_takes``) run as a chain of launches through an fp32 workspace
(``stream_workspace_windows``): LN1 with the FiLM, the qkv product (LN1's
output in three bf16 terms), the MHSA a (window, head) at a time in fp32
with the head in chunks of 32 channels, the proj, LN2, fc1 with the GELU
and fc2, each weight product in warp MMA; the fp32 FMA bodies take those
dims with their workspace.
``structural_block_plain`` is the port of ``_block_body_math`` /
``_window_attention``
(models/structural_transformer.py:97-168), including the key mask of
ragged windows.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ...core.activations import gelu
from . import _build
from ._checks import check_cuda_args, check_no_grad, dtype_code

WINDOW = 8
# the widest dim whose window one block of the kernel holds: past it bf16
# runs in the pair kernel, fp32 keeps a window's residual stream and LN
# output in a workspace, and the plain version carries LN1 and the FiLM in
# float64 as that fp32 path does (csrc/fused_structural_block.cuh's
# kFrameDim)
FRAME_DIM = 256
# fp32 in the workspace: the windows a launch's workspace holds at most at
# dims up to 512 (~202 MB at C = 512; fewer past it, in proportion; more
# only where one image has more windows)
WORKSPACE_WINDOWS = 512
# past this dim the plain version and the fp32 FMA bodies carry the
# residual stream, the proj and the MLP in float64 too (their workspace
# holds 4 x 64 x (C + 1) floats a window): at dims 1024 .. 2048 two fp32
# evaluations of those lay 2.1e-4 .. 5.9e-4 apart on
# chip_smoke.block_stress_inputs, past the fp32 tolerance
RESIDUAL64_DIM = 2 * FRAME_DIM
# the widest head the fp32 FMA bodies hold in shared memory (q | k in
# float64, v and a score tile: 1280 hd + 9088 bytes, at most 227 KB)
FP32_MAX_HEAD = 174
# the bf16 chain's workspace, at most (at least one window)
STREAM_WORKSPACE_BYTES = 256 * 2 ** 20


def head_width(C: int) -> int:
    """hd, the channels of each of ``default_num_heads(C)`` heads."""
    return C // default_num_heads(C)


def kernel_takes(C: int, fp32: bool = False) -> bool:
    """The block kernel's widths: in bf16 any C >= 1 (C % 32 == 0 up to 256
    in the designs of heads of 32, any other C up to 256 with heads of up to
    64 in the head-slot kernel or the FMA bodies, C from 260 to 512 in the
    pair kernel, every other C in the chain: ``stream_takes``); in fp32
    (the FMA bodies past the designs of heads of 32) any C >= 1 whose
    ``default_num_heads(C)`` heads are at most ``FP32_MAX_HEAD`` channels
    wide, every generator dim 4c up to c712 (c716 is the first with wider
    heads: 16 of 179)."""
    return C >= 1 and (not fp32 or head_width(C) <= FP32_MAX_HEAD)


def pair_takes(C: int) -> bool:
    """Whether the bf16 block at dim C runs in the pair kernel: C % 4 == 0
    from 260 to 512 with heads of at most 64 channels."""
    return (FRAME_DIM < C <= 2 * FRAME_DIM and C % 4 == 0
            and head_width(C) <= 64)


def stream_takes(C: int) -> bool:
    """Whether the bf16 block at dim C runs as the streamed chain
    (``csrc/fused_structural_block_stream.cu``): every dim no one-window
    design holds, past 512 or with heads wider than 64 (or, from 260 to
    512, C % 4 != 0)."""
    return C >= 1 and not ((C <= FRAME_DIM and head_width(C) <= 64)
                           or pair_takes(C))


def block_workspace_windows(B: int, H: int, W: int, C: int,
                            fp32: bool) -> int:
    """The windows of fp32 workspace (``workspace_floats(C)`` floats each:
    the residual stream in fp32, float64 past RESIDUAL64_DIM, the LN output
    in float64) a call needs: none
    but for fp32 at C > FRAME_DIM or heads wider than 64, whose launches
    pass the images in slices of whole images of at most WORKSPACE_WINDOWS
    windows (512 / C of it past dim 512; at least one image), one launch a
    slice."""
    if not fp32 or (C <= FRAME_DIM and head_width(C) <= 64):
        return 0
    per_image = -(-H // WINDOW) * -(-W // WINDOW)
    budget = WORKSPACE_WINDOWS * 512 // max(C, 512)
    images = max(1, min(B, budget // per_image))
    return images * per_image


def workspace_floats(C: int) -> int:
    """The fp32 workspace of a window of the FMA bodies: 3 x 64 x (C + 1)
    floats, 4 x 64 x (C + 1) past RESIDUAL64_DIM."""
    return (4 if C > RESIDUAL64_DIM else 3) * 64 * (C + 1)


def stream_workspace_windows(B: int, H: int, W: int, C: int) -> int:
    """The windows of the bf16 chain's workspace (64 x 6C floats each: the
    residual stream, the LN output, then qkv or the MLP's hidden rows):
    at most ``STREAM_WORKSPACE_BYTES``, at least one window, no more than
    the call has."""
    windows = B * -(-H // WINDOW) * -(-W // WINDOW)
    return max(1, min(windows, STREAM_WORKSPACE_BYTES // (64 * 6 * C * 4)))


def slot_takes(C: int) -> bool:
    """Whether the bf16 block at a dim C that is not a multiple of 32 runs
    in the head-slot kernel (tensor cores): C % 4 == 0 from 36 on and heads
    of hd % 4 == 0 channels (every generator dim 4c but c4's 16, where the
    dim-256 frame cost more than the FMA bodies in a probe); any other such
    C runs in the FMA bodies."""
    heads = default_num_heads(C)
    hd = C // heads
    return 32 < C <= 256 and C % 4 == 0 and heads <= 8 and hd % 4 == 0 \
        and hd <= 64


def default_num_heads(dim: int) -> int:
    """Largest head count <= dim // 32 that divides dim (1 if none), as
    ``models/structural_transformer.py::default_num_heads``."""
    h = max(1, dim // 32)
    while dim % h:
        h -= 1
    return h


def weight_shapes(C: int) -> dict:
    """The shape of each block weight at width C, by keyword name."""
    return {"norm1_w": (C,), "norm1_b": (C,), "qkv_w": (3 * C, C),
            "qkv_b": (3 * C,), "proj_w": (C, C), "proj_b": (C,),
            "norm2_w": (C,), "norm2_b": (C,), "fc1_w": (4 * C, C),
            "fc1_b": (4 * C,), "fc2_w": (C, 4 * C), "fc2_b": (C,)}


WEIGHT_NAMES = tuple(weight_shapes(1))  # the order the C entry point takes


def block_launch_shape(B: int, H: int, W: int, C: int = 64) -> tuple:
    """(units of work, dynamic shared memory in bytes) of one bf16 launch
    of the block kernel, as ``csrc/fused_structural_block.cu`` lays it out
    (ragged edges count as whole windows). The streamed chain
    (``stream_takes``): its MHSA launch, a block a (window, head) with
    static shared memory only. C % 32 != 0 with ``slot_takes``
    (every generator dim from 48 on): the head-slot kernel, a persistent block a
    window, the dim-256 frame's two weight tiles of 64 rows of 264 and
    LN1's (then LN2's) output as hi and lo, then a union of one head's q, k,
    v and output tiles (hi and lo, 64 rows of S + 8) and the hidden chunk
    (hi and lo, rows of 136); the fp32 parameters (qkv's biases in the slot
    layout of up to 8 heads of 64) and 256 row sums of LN2. Any other C %
    32 != 0: the FMA bodies, one block of 256 threads per window (a grid of
    every window, not a persistent one): the residual stream and LN1's
    (then LN2's) output as two 64 x (C + 1) fp32 rows, and a union of one
    head (q | k, 64 x (2 hd + 1), and 16 score rows in fp32; v, 64 x (hd +
    1)) and a 64-column hidden chunk (64 x 65 fp32). C = 32 and 64: a
    persistent block
    takes two 8x8 windows at a time; it holds the four weights as bf16 in
    rows padded by 8 values, per window x, struct and the k (hi, lo) and v
    tiles of every head (64 rows of 40), then the biases and LayerNorm
    parameters as fp32. C = 96 and 128, in the layout of DP = 128: a block
    takes one window; qkv and proj are resident, fc1 and fc2 pass through
    two buffers of 16 hidden columns (fc1 rows of DP + 8, fc2 rows of 24),
    then x and one head's three tiles. C = 160 to 256, in the layout of DP =
    256: a block takes one window; every weight passes through two tiles of
    64 rows of DP + 8; LN1's (then LN2's) output as hi and lo, then either
    the k and v tiles (hi and lo) of two heads beside the pair's output (hi
    and lo, rows of 72) or the hidden chunk (hi and lo, rows of 136); the
    fp32 parameters and 256 row sums of LN2. C from 260 on (``pair_takes``):
    the pair kernel, a unit a window and a cluster of two blocks, each
    holding two weight tiles of 32 rows of 520, its 32 tokens' LN output as
    hi and lo (rows of 520), then a union of the head's q and o (its 32
    tokens) and k and v (the window's 64), hi and lo in rows of S + 8, or the
    hidden chunk (hi and lo, rows of 72); the fp32 parameters (qkv's biases
    in the slot layout of up to 16 heads of 64) and the LN2 row sums of 4
    warps a row. The grid is ``persistent_grid(units, SMs, blocks per SM)``
    (in clusters of two for the pair kernel)."""
    windows = B * -(-H // WINDOW) * -(-W // WINDOW)
    if stream_takes(C):
        return windows * default_num_heads(C), 0
    if pair_takes(C):
        slot = -(-(C // default_num_heads(C)) // 16) * 16
        elems = (2 * 32 * 520 + 2 * 32 * 520
                 + max(384 * (slot + 8), 2 * 32 * 72))
        return windows, 2 * elems + 4 * (4 * 512 + 3 * 16 * 64 + 512 + 2048
                                         + 512 + 256)
    if C % 32 and slot_takes(C):
        slot = -(-(C // default_num_heads(C)) // 16) * 16
        elems = 4 * 64 * 264 + max(8 * 64 * (slot + 8), 2 * 64 * 136)
        return windows, 2 * elems + 4 * (4 * 256 + 3 * 8 * 64 + 256 + 1024
                                         + 256 + 256)
    if C % 32:
        hd = C // default_num_heads(C)
        head = 4 * (64 * (2 * hd + 1) + 16 * 65 + 64 * (hd + 1))
        return windows, 2 * 64 * (C + 1) * 4 + max(head, 4 * 64 * 65)
    if C > 128:
        dp = 256
        heads = 2 * 4 * 64 * 40 + 2 * 64 * 72
        elems = 2 * 64 * (dp + 8) + 2 * 64 * (dp + 8) + max(heads, 2 * 64 * 136)
        return windows, 2 * elems + 4 * 13 * dp + 4 * 256
    if C > 64:
        dp = 128
        chunk = 16 * (dp + 8) + dp * 24
        elems = 4 * dp * (dp + 8) + 2 * chunk + 64 * (dp + 8) + 3 * 64 * 40
        return windows, 2 * elems + 4 * 13 * dp
    weights = 8 * C * (C + 8) + C * (4 * C + 8)
    group = 2 * 64 * (C + 8) + 3 * default_num_heads(C) * 64 * 40
    return -(-windows // 2), 2 * (weights + 2 * group) + 4 * 13 * C


def _window_mhsa(h, qkv_w, qkv_b):
    """Windowed multi-head self-attention of (B, H, W, C) tokens (LN1's
    output: fp32, float64 past dim 256), before the output projection. The
    grid is zero-padded to window multiples after the qkv product; padded
    keys are masked out of every softmax and padded queries cropped. q, k,
    their scores and the softmax are carried in float64 from the tokens and
    the fp32 weights, and the
    softmax meets v in fp32: on a block whose scores are 16 times larger
    (``chip_smoke.block_stress_inputs``) fp32 scores at dim 256 leave the
    block 2.6e-4 from a float64 evaluation, past the fp32 tolerance the
    kernel is held to (2e-4), and these 8.6e-5
    (``devtools/serving_kernel_rounding.py --fp32``)."""
    B, H, W, C = h.shape
    window = WINDOW
    heads = default_num_heads(C)
    hd = C // heads
    qkv = F.linear(h.double(), qkv_w.double(), qkv_b.double())
    ph, pw = (-H) % window, (-W) % window
    qkv = F.pad(qkv, (0, 0, 0, pw, 0, ph))
    nh, nw = (H + ph) // window, (W + pw) // window
    t = qkv.reshape(B, nh, window, nw, window, 3 * C).permute(0, 1, 3, 2, 4, 5)
    t = t.reshape(-1, window * window, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]                     # (Bw, heads, T, hd)
    attn = (q @ k.transpose(-2, -1)) * (1.0 / math.sqrt(hd))
    if ph or pw:
        valid = F.pad(torch.ones(H, W, device=h.device), (0, pw, 0, ph))
        valid = valid.reshape(nh, window, nw, window).permute(0, 2, 1, 3)
        valid = valid.reshape(1, nh * nw, 1, 1, window * window) > 0
        attn = attn.reshape(B, nh * nw, heads, window * window, -1)
        attn = attn.masked_fill(~valid, float("-inf")).flatten(0, 1)
    out = torch.softmax(attn, dim=-1).float() @ v.float()   # (Bw, heads, T, hd)
    out = out.permute(0, 2, 1, 3).reshape(B, nh, nw, window, window, C)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, H + ph, W + pw, C)
    return out[:, :H, :W]


def structural_block_plain(x, struct, gamma, beta, *, norm1_w, norm1_b,
                           qkv_w, qkv_b, proj_w, proj_b, norm2_w, norm2_b,
                           fc1_w, fc1_b, fc2_w, fc2_b,
                           eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the block body on (B, H, W, C) tokens.

    gamma, beta: (B, C) FiLM modulation. Weights in the PyTorch Linear
    (out, in) layout. Computes in fp32 and rounds once to x's type, as the
    kernel does.
    """
    C = x.shape[-1]
    f = lambda t: t.float()
    xf = x.float()
    # past FRAME_DIM, LN1 and the FiLM in float64, as the fp32 kernel carries
    # them there: on a block whose scores are 16 times larger
    # (chip_smoke.block_stress_inputs) an fp32 LN1 output leaves the block
    # at dim 512 1.6e-4 from a float64 evaluation, and two fp32 evaluations
    # 2.3e-4 apart, past the fp32 tolerance; a float64 one 6.8e-5
    # (devtools/serving_kernel_rounding.py --fp32)
    d = (lambda t: t.double()) if C > FRAME_DIM else f
    h = F.layer_norm(d(xf + f(struct)), (C,), d(norm1_w), d(norm1_b), eps)
    h = h * (1.0 + d(gamma)[:, None, None, :]) + d(beta)[:, None, None, :]
    # past RESIDUAL64_DIM the residual stream, the proj and the MLP in
    # float64 too, as the fp32 kernel carries them there
    r = (lambda t: t.double()) if C > RESIDUAL64_DIM else f
    xf = r(xf) + F.linear(r(_window_mhsa(h, f(qkv_w), f(qkv_b))),
                          r(proj_w), r(proj_b))
    h = F.layer_norm(xf, (C,), r(norm2_w), r(norm2_b), eps)
    h = F.linear(gelu(F.linear(h, r(fc1_w), r(fc1_b))), r(fc2_w), r(fc2_b))
    return (xf + h).to(x.dtype)


def fused_structural_block(x, struct, gamma, beta, *, eps: float = 1e-5,
                           **weights) -> torch.Tensor:
    """The block body on (B, H, W, C) tokens; weights by the keyword names
    in ``WEIGHT_NAMES``.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (contiguous fp32 or bf16 x and struct, weights of the same type,
    ``kernel_takes(C, fp32)``, any H and W; 8x8 windows) or raises. The kernel is
    forward-only: a CUDA call that autograd would record raises (the
    training route is the block body in autograd around
    ``window_mhsa_train``).
    """
    if sorted(weights) != sorted(WEIGHT_NAMES):
        raise TypeError(f"fused_structural_block takes the weights "
                        f"{WEIGHT_NAMES}, got {sorted(weights)}")
    if x.device.type == "cpu":
        return structural_block_plain(x, struct, gamma, beta, eps=eps,
                                      **weights)
    check_no_grad("fused_structural_block", x, struct, gamma, beta,
                  *weights.values())
    B, H, W, C = x.shape
    fp32 = x.dtype == torch.float32
    if not kernel_takes(C, fp32):
        raise ValueError(f"fused_structural_block kernel is built in fp32 "
                         f"for dims whose heads are at most {FP32_MAX_HEAD} "
                         f"channels wide, got C={C} in heads of "
                         f"{head_width(C)}")
    shapes = weight_shapes(C)
    check_cuda_args("fused_structural_block", x,
                    {"struct": (struct, x.shape),
                     **{n: (weights[n], shapes[n]) for n in WEIGHT_NAMES}})
    gamma = gamma.to(x.device, torch.float32).reshape(B, C).contiguous()
    beta = beta.to(x.device, torch.float32).reshape(B, C).contiguous()
    ptrs = (ctypes.c_void_p * len(WEIGHT_NAMES))(
        *[weights[n].data_ptr() for n in WEIGHT_NAMES])
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    chain = not fp32 and stream_takes(C)
    if chain:   # bf16 past the one-window designs: the streamed chain
        ws_windows = stream_workspace_windows(B, H, W, C)
        ws = torch.empty(ws_windows * 64 * 6 * C, device=x.device)
    else:
        ws_windows = block_workspace_windows(B, H, W, C, fp32)
        ws = (torch.empty(ws_windows * workspace_floats(C), device=x.device)
              if ws_windows else None)
    # bf16 past dim 256: the pair kernel's own source and entry point, or
    # the chain's
    ws_args = (None if ws is None else ws.data_ptr(), ws_windows)
    entry, extra = (("fused_structural_block_stream", ws_args) if chain
                    else ("fused_structural_block_pair", ())
                    if pair_takes(C) and not fp32
                    else ("fused_structural_block", ws_args))
    if x.numel():
        rc = _build.kernel(entry)(
            x.data_ptr(), struct.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            ptrs, y.data_ptr(), B, H, W, C, dtype_code(x), eps, *extra,
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"fused_structural_block launch failed: "
                               f"CUDA error {rc}")
        # one launch, or one a slice of the images the fp32 workspace
        # holds; the chain's call counts as one launch of the block
        per_image = -(-H // WINDOW) * -(-W // WINDOW)
        fused_structural_block.launches += (
            -(-B // (ws_windows // per_image)) if ws_windows and not chain
            else 1)
    return y


fused_structural_block.launches = 0
