"""Height-sharded inference (port of ``parallel/spatial.py``).

One image whose activations outgrow one card is split along its height
over a list of devices, one row shard each; the batch stays whole (data
parallelism is ``parallel.mesh``). The JAX package annotates the input's
height axis and lets GSPMD insert the halo exchanges and the global
reductions. The port has no partitioner: it states every exchange itself,
from one process driving the list of devices (the single-controller model
of GSPMD, and of ``batch_process(devices=[...])``):

- a convolution takes halo rows from the neighbouring shards, copied to
  its shard's device (zero rows at the image's top and bottom edges only),
  and runs without height padding; a transposed convolution takes one row
  each side and crops its output;
- InstanceNorm takes global statistics: each shard's count, mean and M2 in
  fp32 (``torch.var_mean``, Welford, as the unsharded path,
  ``core/norm.py``), combined by Chan's parallel formula in float64 on the
  first device; the style vector takes the global mean;
- LocalAttention's 4x4 windows never cross a shard (a shard's height at
  every stage is a multiple of 4): its module runs on each shard, through
  the kernel on a CUDA device;
- the transformer block's 8-row windows do cross shards: the token rows
  move so that each device holds the windows whose first row lies in its
  shard (``window_pieces``), the block body runs on each piece (the last
  one with the global grid's own padded window), and the rows move back.
  So the block computes the global function at every shard height.

A device may repeat: ``[cuda:0] * 4`` is a one-card stand-in for four
cards, ``[cpu] * 8`` the CPU tests' stand-in for JAX's 8 virtual devices.
Work is queued shard by shard: on distinct cards it overlaps (CUDA is
asynchronous per device), on a repeated device it runs in turn. Each
distinct device holds a replica of the parameters.
"""

from __future__ import annotations

import contextlib
import copy
from collections.abc import Iterator

import torch
import torch.nn.functional as F
from torch import nn

from ..core.conv import linear
from . import mesh

STRIDE = 16       # the generators' stride budget: H % (16 * shards) == 0
WINDOW = 8        # the transformer block's window, in token rows
MSB_HALO = 4      # the multi-scale block's widest branch: 3x3 at dilation 4
CHANNELS_LAST = torch.channels_last


def spatial_mesh(n_devices: int | None = None,
                 devices=None) -> list[torch.device]:
    """The devices of a height-sharded run: the first ``n_devices`` of
    ``devices`` (default: every local CUDA card, ``mesh.local_devices()``).
    A device may repeat. Fewer than ``n_devices`` raises JAX's message."""
    devices = [_indexed(d) for d in (devices if devices is not None
                                     else mesh.local_devices())]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return devices


def _indexed(d) -> torch.device:
    """``d`` as a torch.device, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _on(device: torch.device):
    """The device's context: a kernel's C entry point sets the current
    device itself, PyTorch's ops follow their tensors."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# exchanges over a list of row shards

def _offsets(parts, dim: int) -> list[int]:
    """The first global row of each part, then the total."""
    off = [0]
    for p in parts:
        off.append(off[-1] + p.shape[dim])
    return off


def take_rows(parts, start: int, stop: int, device,
              dim: int = 2) -> torch.Tensor:
    """Global rows [start, stop) of the row shards ``parts`` (consecutive
    along ``dim``: 2 for NCHW, 1 for NHWC), as a new tensor on ``device``;
    rows outside the image are zeros. Always a copy, never a view of a
    shard, so no later op on a shard can reach it."""
    off = _offsets(parts, dim)
    fmt = CHANNELS_LAST if dim == 2 else torch.contiguous_format
    ref = parts[0]

    def zeros(n):
        shape = list(ref.shape)
        shape[dim] = n
        return torch.empty(shape, dtype=ref.dtype, device=device,
                           memory_format=fmt).zero_()

    pieces = []
    if start < 0:
        pieces.append(zeros(min(stop, 0) - start))
    for p, lo_p, hi_p in zip(parts, off, off[1:]):
        lo, hi = max(start, lo_p), min(stop, hi_p)
        if lo < hi:
            pieces.append(p.narrow(dim, lo - lo_p, hi - lo).to(device))
    if stop > off[-1]:
        pieces.append(zeros(stop - max(start, off[-1])))
    return torch.cat(pieces, dim).contiguous(memory_format=fmt)


def halo_rows(xs, top: int, bottom: int) -> Iterator[torch.Tensor]:
    """Each NCHW shard with ``top`` rows of the image above it and
    ``bottom`` below: its neighbours' rows on its own device, zero rows
    past the image's top and bottom edges.

    Every shard's edge rows are copied before the first shard is
    yielded: a copy between two cards waits for the work queued on both,
    so a copy queued after a shard's convolution would hold the next card
    until that convolution ends. The padded shards are then made one at
    a time, so that a caller holds one while it uses it."""
    off = _offsets(xs, 2)
    above = [take_rows(xs, off[i] - top, off[i], x.device) if top else None
             for i, x in enumerate(xs)]
    below = [take_rows(xs, off[i + 1], off[i + 1] + bottom, x.device)
             if bottom else None for i, x in enumerate(xs)]
    for a, x, b in zip(above, xs, below):
        yield torch.cat([t for t in (a, x, b) if t is not None],
                        dim=2).contiguous(memory_format=CHANNELS_LAST)


def instance_norm_stats(xs, eps: float = 1e-5):
    """Global InstanceNorm statistics of the NCHW row shards: one (mean,
    rstd) pair a shard, each (B, C, 1, 1) fp32 on the shard's device. Each
    shard's count, mean and M2 come from fp32 ``torch.var_mean``; Chan's
    parallel formula combines them in float64 on the first device."""
    dev0 = xs[0].device
    n = mean = m2 = None
    for x in xs:
        var_i, mean_i = torch.var_mean(x.float(), dim=(2, 3), correction=0)
        n_i = x.shape[2] * x.shape[3]
        mean_i = mean_i.to(dev0, torch.float64)
        m2_i = var_i.to(dev0, torch.float64) * n_i
        if n is None:
            n, mean, m2 = n_i, mean_i, m2_i
            continue
        delta = mean_i - mean
        total = n + n_i
        mean = mean + delta * (n_i / total)
        m2 = m2 + m2_i + delta.square() * (n * n_i / total)
        n = total
    rstd = torch.rsqrt(m2 / n + eps).float()[..., None, None]
    mean = mean.float()[..., None, None]
    return [(mean.to(x.device), rstd.to(x.device)) for x in xs]


def in_relu_rows(xs, eps: float = 1e-5) -> list[torch.Tensor]:
    """``relu(instance_norm(x))`` of the whole image, shard by shard."""
    return [((x.float() - mean) * rstd).relu_().to(x.dtype)
            for x, (mean, rstd) in zip(xs, instance_norm_stats(xs, eps))]


def global_mean(xs) -> torch.Tensor:
    """(B, C) mean over the whole image's H and W of the NCHW row shards,
    fp32 on the first device (the shards' fp32 means weighted in
    float64)."""
    dev0 = xs[0].device
    total = sum(x.float().mean(dim=(2, 3)).to(dev0, torch.float64)
                * (x.shape[2] * x.shape[3]) for x in xs)
    return (total / sum(x.shape[2] * x.shape[3] for x in xs)).float()


def window_pieces(offsets, rows: int) -> list[int]:
    """The first token row of each shard's piece, then ``rows``: a shard
    takes the 8-row windows whose first row lies in it (rows
    [offsets[i], offsets[i + 1])), so every piece but the last is whole
    windows, the last ends with the global grid's own last window, and a
    piece is empty where no window starts in its shard."""
    return [min(-(-o // WINDOW) * WINDOW, rows) for o in offsets[:-1]] + [rows]


def gather_rows(shards, device) -> torch.Tensor:
    """The whole (B, H, W, C) image from its NHWC row shards, on
    ``device``."""
    return torch.cat([s.to(device) for s in shards], dim=1)


# ---------------------------------------------------------------------------
# layers on row shards; ``mods`` holds one module a shard (a replica on the
# shard's device)

def _conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m`` on x without height padding (halo rows stand in for it),
    weights cast to x's type as ``core.conv`` does."""
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), bias, m.stride,
                    (0, m.padding[1]), m.dilation, m.groups)


def conv_rows(convs, xs) -> list[torch.Tensor]:
    """A Conv2d over the row shards: ``padding`` halo rows above each
    shard, d (k - 1) - padding - (stride - 1) below (3 / 3 for the 7x7
    convs, 1 / 1 for the 4x4 stride-2 ones, 1 / 0 for the 3x3 stride-2
    structure embedding)."""
    m = convs[0]
    top = m.padding[0]
    bottom = m.dilation[0] * (m.kernel_size[0] - 1) - top - (m.stride[0] - 1)
    return [_conv(c, h) for c, h in zip(convs, halo_rows(xs, top, bottom))]


def conv_transpose_rows(convs, xs) -> list[torch.Tensor]:
    """A ConvTranspose2d over the row shards: the input rows that reach
    the shard's output rows (one each side for 4x4 stride 2 padding 1),
    the transposed conv without height padding, its output cropped to the
    shard's stride x h rows."""
    m = convs[0]
    k, s, p = m.kernel_size[0], m.stride[0], m.padding[0]
    top, bottom = -(-(k - 1 - p) // s), (s - 1 + p) // s
    first = s * top + p
    out = []
    for c, h, x in zip(convs, halo_rows(xs, top, bottom), xs):
        bias = None if c.bias is None else c.bias.to(h.dtype)
        y = F.conv_transpose2d(h, c.weight.to(h.dtype), bias, c.stride,
                               (0, c.padding[1]), c.output_padding, c.groups,
                               c.dilation)
        out.append(y[:, :, first:first + s * x.shape[2]])
    return out


def _sub(mods, name: str) -> list[nn.Module]:
    return [m.get_submodule(name) for m in mods]


def multi_scale_rows(blocks, xs) -> list[torch.Tensor]:
    """``MultiScaleBlock`` over the row shards: one halo of 4 rows serves
    the four branches (each crops the rows its dilation does not reach),
    global statistics for both IN + ReLU."""
    from ..models.enhanced_generator import _MSB_BRANCHES

    h = []
    for blk, halo in zip(blocks, halo_rows(xs, MSB_HALO, MSB_HALO)):
        h.append(torch.cat([_conv(getattr(blk, name)[0],
                                  halo[:, :, MSB_HALO - pad:
                                       halo.shape[2] - MSB_HALO + pad])
                            for name, _, pad, _ in _MSB_BRANCHES], dim=1))
    # each list is dropped as soon as the next exists, as the unsharded
    # forward's temporaries are
    h = in_relu_rows(h)
    h = [_conv(blk.fusion[0], t) for blk, t in zip(blocks, h)]
    return [y.add_(x) for y, x in zip(in_relu_rows(h), xs)]


def _stage_rows(stages, xs, transpose: bool) -> list[torch.Tensor]:
    """A down (conv) or up (transposed conv) stage: conv, IN + ReLU,
    LocalAttention on each shard, MultiScaleBlock."""
    first = conv_transpose_rows if transpose else conv_rows
    h = in_relu_rows(first([s[0] for s in stages], xs))
    for i, s in enumerate(stages):   # each shard's input dropped in turn
        with _on(h[i].device):
            h[i] = s[3](h[i])
    return multi_scale_rows([s[4] for s in stages], h)


def structure_rows(blocks, xs, tokens) -> list[torch.Tensor]:
    """The block's structure tokens over the row shards (NHWC, tokens'
    type): ``struct_embed``'s two 3x3 stride-2 convs on the network input
    shards, then ``struct_proj``."""
    s = [x.to(tokens[0].dtype) for x in xs]
    for i in (0, 2):
        s = [torch.relu(t) for t in
             conv_rows([b.struct_embed[i] for b in blocks], s)]
    return [linear(b.struct_proj, t.permute(0, 2, 3, 1))
            for b, t in zip(blocks, s)]


def block_rows(blocks, tokens, struct, films) -> list[torch.Tensor]:
    """The block body over NHWC token row shards: the rows move to the
    window-aligned pieces (``window_pieces``), the body runs on each
    non-empty piece on its shard's device, and the rows move back to the
    shards. ``films``: a (gamma, beta) pair on each shard's device."""
    off = _offsets(tokens, 1)
    starts = window_pieces(off, off[-1])
    pieces = []
    for i, (blk, t, (gamma, beta)) in enumerate(zip(blocks, tokens, films)):
        lo, hi = starts[i], starts[i + 1]
        if lo == hi:
            pieces.append(t[:, :0])   # no window starts in this shard
            continue
        with _on(t.device):
            pieces.append(blk.body(take_rows(tokens, lo, hi, t.device, 1),
                                   take_rows(struct, lo, hi, t.device, 1),
                                   gamma, beta))
    return [take_rows(pieces, off[i], off[i + 1], t.device, 1)
            for i, t in enumerate(tokens)]


def enhanced_rows(mods, xs) -> list[torch.Tensor]:
    """``EnhancedGenerator.forward`` over NCHW input row shards, line by
    line (``models/enhanced_generator.py``)."""
    h = in_relu_rows(conv_rows(_sub(mods, "initial.0"), xs))
    for name in ("down1", "down2"):
        h = _stage_rows(_sub(mods, name), h, transpose=False)
    style = torch.relu(linear(mods[0].style_encoder[2], global_mean(h)))
    tokens = [t.contiguous(memory_format=CHANNELS_LAST).permute(0, 2, 3, 1)
              for t in h]
    for i in range(len(mods[0].transformer_blocks)):
        blocks = _sub(mods, f"transformer_blocks.{i}")
        struct = structure_rows(blocks, xs, tokens)
        gamma, beta = blocks[0].film(style)
        films = [(gamma.to(t.device), beta.to(t.device)) for t in tokens]
        tokens = block_rows(blocks, tokens, struct, films)
    h = [t.permute(0, 3, 1, 2) for t in tokens]
    for name in ("up1", "up2"):
        h = _stage_rows(_sub(mods, name), h, transpose=True)
    return [torch.tanh(y) for y in conv_rows(_sub(mods, "output.0"), h)]


def plain_rows(mods, xs) -> list[torch.Tensor]:
    """``PlainGenerator.forward`` in eval mode over NCHW input row shards:
    convs and transposed convs with halos, BatchNorm on its running
    statistics, the activations shard by shard."""
    from ..core.norm import batch_norm   # core.norm imports this package

    h = xs
    for part in ("encoder", "decoder"):
        for j, m in enumerate(getattr(mods[0], part)):
            subs = _sub(mods, f"{part}.{j}")
            if isinstance(m, nn.ConvTranspose2d):
                h = conv_transpose_rows(subs, h)
            elif isinstance(m, nn.Conv2d):
                h = conv_rows(subs, h)
            elif isinstance(m, nn.BatchNorm2d):
                h = [batch_norm(t, bn.running_mean, bn.running_var, bn.weight,
                                bn.bias, training=False, eps=bn.eps)
                     for bn, t in zip(subs, h)]
            elif isinstance(m, nn.LeakyReLU):
                h = [torch.where(t >= 0, t, t * m.negative_slope) for t in h]
            else:
                h = [f(t) for f, t in zip(subs, h)]
    return h


# ---------------------------------------------------------------------------
# the entry point

def spatial_apply(model, devices=None, n_devices: int | None = None,
                  fast_attention: bool = False):
    """Height-sharded counterpart of ``LoadedModel.apply``.

    Returns ``apply(x)``: x (B, H, W, 3) in [-1, 1] on any device, H
    divisible by 16 x the shard count, split into row shards on the
    devices; it returns the list of the output's (B, H / shards, W, 3) row
    shards, each on its device (``gather_rows`` joins them). The devices:
    ``devices`` (a device may repeat), else the first ``n_devices`` local
    CUDA cards for a model on the card, and ``n_devices`` copies of the
    model's device otherwise (one without ``n_devices``). It runs under
    ``torch.inference_mode()`` with TF32 by the model's precision, as
    ``LoadedModel.apply``.

    ``fast_attention`` is taken for the JAX signature (enhanced models
    only): on a CUDA device the kernels always run, on the CPU their plain
    versions.
    """
    if fast_attention and model.kind != "enhanced":
        raise ValueError("fast_attention applies to enhanced models only")
    if devices is None and model.device.type != "cuda":
        devices = [model.device] * (n_devices or 1)
    devices = spatial_mesh(n_devices, devices)
    if not devices:
        raise ValueError("need at least 1 device, have 0")
    replicas = {}
    for d in devices:
        if d not in replicas:
            replicas[d] = (model.module if d == model.device
                           else copy.deepcopy(model.module).to(d))
    mods = [replicas[d] for d in devices]
    forward = {"plain": plain_rows, "enhanced": enhanced_rows}[model.kind]
    sp = len(devices)

    def apply(x: torch.Tensor) -> list[torch.Tensor]:
        H = x.shape[1]
        if H % (STRIDE * sp):
            raise ValueError(
                f"height {H} not divisible by 16 * {sp} mesh shards")
        h = H // sp
        xs = [x[:, i * h:(i + 1) * h].contiguous().to(d).permute(0, 3, 1, 2)
              for i, d in enumerate(devices)]
        cudnn = torch.backends.cudnn
        with torch.inference_mode(), cudnn.flags(
                enabled=True, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic,
                allow_tf32=model.precision != "highest"):
            ys = forward(mods, xs)
        return [y.permute(0, 2, 3, 1) for y in ys]

    return apply
