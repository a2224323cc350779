"""Space-to-depth packed execution (port of ``ops/packed.py``).

The packed engine runs the EnhancedGenerator on s2d tensors: an f x f block
of pixels folds into the channel axis, (B, H, W, C) -> (B, H/f, W/f,
f*f*C) in the JAX channel order (pi, pj, c), and every layer is re-expressed
on that layout with the same math:

- conv / transposed conv: the weights are repacked once per model load by
  an exact index mapping (``pack_conv2d_weight``,
  ``pack_conv_transpose2d_weight``), and the packed layer is one cuDNN
  conv on f*f-times-wider channels;
- InstanceNorm: statistics per original channel pool its f*f phases;
- LocalAttention (4x4 windows): at f == 4 a window is one packed pixel,
  and ``packed_window_channel_attention`` runs on the packed rows.

Tensors are NHWC here, as in the JAX module, so packed weights and
activations compare one to one with the JAX ones. A contiguous NHWC tensor
is a ``channels_last`` NCHW one, so the convolutions take it without a
copy. Conv weights are in the PyTorch layouts: OIHW for a conv, IOHW for a
transposed conv; 1x1 matrices (out, in).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .kernels.packed_window_attention import packed_window_channel_attention
from .kernels.window_relayout import window_relayout

__all__ = [
    "depth_to_space", "pack_conv2d_spec", "pack_conv2d_weight",
    "pack_conv_transpose2d_spec", "pack_conv_transpose2d_weight",
    "packed_conv2d", "packed_conv_transpose2d", "packed_global_avg_pool",
    "packed_instance_norm", "packed_per_channel_linear",
    "packed_window_channel_attention", "space_to_depth",
]


# ---------------------------------------------------------------------------
# Layout transforms
# ---------------------------------------------------------------------------

def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, f*f*C), channel order (pi, pj, c); the
    relayout kernel on a CUDA tensor."""
    return window_relayout(x, f)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    return window_relayout(x, f, inverse=True)


# ---------------------------------------------------------------------------
# Exact conv weight repacking (host-side numpy index maps)
# ---------------------------------------------------------------------------

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@functools.lru_cache(maxsize=None)
def _conv_axis_map(K: int, stride: int, pad: int, dil: int, f_in: int,
                   f_out: int):
    """1-D tap mapping for a conv between s2d grids (JAX :69-94).

    Original: y[t] = sum_k w[k] x[stride*t + dil*k - pad]. Packed output
    index u, phase a (t = f_out*u + a); packed input v, phase b
    (m = f_in*v + b). For each (a, k): q = stride*a + dil*k - pad gives the
    packed tap d = q // f_in and the phase b = q % f_in.

    Returns (M, d_min, K_p, stride_p), M a 0/1 array (K, f_out, K_p, f_in)
    with M[k, a, d - d_min, b] = 1.
    """
    assert (stride * f_out) % f_in == 0, "incompatible packing factors"
    stride_p = (stride * f_out) // f_in
    entries = [(k, a, (stride * a + dil * k - pad) // f_in,
                (stride * a + dil * k - pad) % f_in)
               for a in range(f_out) for k in range(K)]
    d_min = min(e[2] for e in entries)
    K_p = max(e[2] for e in entries) - d_min + 1
    M = np.zeros((K, f_out, K_p, f_in), np.float64)
    for k, a, d, b in entries:
        M[k, a, d - d_min, b] = 1.0
    return M, d_min, K_p, stride_p


@functools.lru_cache(maxsize=None)
def _convt_axis_map(K: int, stride: int, pad: int, f_in: int, f_out: int):
    """1-D tap mapping for a transposed conv between s2d grids (JAX
    :161-187).

    Original (torch semantics): y[t] += w[k] x[m] whenever
    t = stride*m + k - pad. Packed: t = f_out*u + a, m = f_in*v + b; a
    contribution exists when k = f_out*e + a + pad - stride*b, for
    e = u - S_pp*v, with packed stride S_pp = stride*f_in/f_out.

    Returns (M, e_min, K_p, S_pp) with M[k, a, e - e_min, b] = 1.
    """
    assert (stride * f_in) % f_out == 0, "incompatible packing factors"
    S_pp = (stride * f_in) // f_out
    entries = [(k, a, (k - a - pad + stride * b) // f_out, b)
               for a in range(f_out) for b in range(f_in) for k in range(K)
               if (k - a - pad + stride * b) % f_out == 0]
    e_min = min(e[2] for e in entries)
    K_p = max(e[2] for e in entries) - e_min + 1
    M = np.zeros((K, f_out, K_p, f_in), np.float64)
    for k, a, e, b in entries:
        M[k, a, e - e_min, b] = 1.0
    return M, e_min, K_p, S_pp


@functools.lru_cache(maxsize=None)
def pack_conv2d_spec(K, *, f_in: int, f_out: int, stride=1, padding=0,
                     dilation=1) -> dict:
    """The static {stride, padding} of a repacked conv, from integer math
    alone; matches :func:`pack_conv2d_weight`. Padding is symmetric per
    axis, (ph, pw)."""
    (Kh, Kw), s, p, d = _pair(K), _pair(stride), _pair(padding), _pair(dilation)
    _, dmin_i, _, sp_h = _conv_axis_map(Kh, s[0], p[0], d[0], f_in, f_out)
    _, dmin_j, _, sp_w = _conv_axis_map(Kw, s[1], p[1], d[1], f_in, f_out)
    return {"stride": (sp_h, sp_w), "padding": (-dmin_i, -dmin_j)}


def _repack(w, Mi, Mj, pattern, shape):
    """The packed kernel of ``pattern`` (``kadb,lceg,<w>-><out>``: the sum
    over k, l of the 0/1 tap maps times ``w``), on the CPU. At most one k
    maps to each (a, d, b) and one l to each (c, e, g), so every packed
    entry is one original weight or zero: each (k, l) tap pair copies its
    weight slice into a zeroed kernel, exactly."""
    ins, out = pattern.split("->")
    m_i, m_j, w_labels = ins.split(",")
    assert out.index(w_labels[0]) < out.index(w_labels[1])
    sizes = dict(zip(m_i, Mi.shape)) | dict(zip(m_j, Mj.shape))
    sizes |= dict(zip(w_labels, w.shape))
    w = w.detach().cpu()
    w_p = torch.zeros([sizes[c] for c in out], dtype=w.dtype)
    for k, *ti in np.argwhere(Mi):
        for l, *tj in np.argwhere(Mj):
            at = dict(zip(m_i[1:], ti)) | dict(zip(m_j[1:], tj))
            w_p[tuple(at.get(c, slice(None)) for c in out)] = w[:, :, k, l]
    return w_p.reshape(shape)


def _tile_bias(b, f):
    return None if b is None else b.detach().cpu().repeat(f * f)


def pack_conv2d_weight(w, b, *, f_in: int, f_out: int, stride=1, padding=0,
                       dilation=1):
    """Repack an OIHW conv kernel to act on s2d(f_in) input -> s2d(f_out)
    output.

    Returns (w_p, b_p, spec): w_p OIHW of shape (f_out^2 Cout, f_in^2 Cin,
    K_p, K_p), on the CPU; spec for :func:`packed_conv2d`. Zero padding in
    the packed domain is whole-pixel zero padding in the original one, and
    taps that would reach past it carry zero weight by construction.
    """
    Cout, Cin, Kh, Kw = w.shape
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    Mi, _, Kph, _ = _conv_axis_map(Kh, s[0], p[0], d[0], f_in, f_out)
    Mj, _, Kpw, _ = _conv_axis_map(Kw, s[1], p[1], d[1], f_in, f_out)
    # w_p[(a, c, o), (b, g, i), d, e] = sum_{k,l} Mi[k,a,d,b] Mj[l,c,e,g] w[o,i,k,l]
    w_p = _repack(w, Mi, Mj, "kadb,lceg,oikl->acobgide",
                  (f_out * f_out * Cout, f_in * f_in * Cin, Kph, Kpw))
    spec = pack_conv2d_spec((Kh, Kw), f_in=f_in, f_out=f_out, stride=s,
                            padding=p, dilation=d)
    return w_p, _tile_bias(b, f_out), spec


def packed_conv2d(x, w_p, b_p, spec, *, out_hw=None) -> torch.Tensor:
    """Conv of a packed NHWC tensor with a repacked OIHW kernel.

    out_hw: the packed output (H, W). The symmetric ``-d_min`` padding is
    exact for f_in == f_out but over-produces trailing rows when
    f_in != f_out; pass the true packed output size to crop.
    """
    b = None if b_p is None else b_p.to(x.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), w_p.to(x.dtype), b,
                   stride=spec["stride"], padding=spec["padding"])
    out = out.permute(0, 2, 3, 1)
    if out_hw is not None:
        out = out[:, :out_hw[0], :out_hw[1], :]
    return out.contiguous()


@functools.lru_cache(maxsize=None)
def pack_conv_transpose2d_spec(K, *, f_in: int, f_out: int, stride=1,
                               padding=0) -> dict:
    """The static {stride, padding, kernel} of a repacked transposed conv;
    matches :func:`pack_conv_transpose2d_weight`."""
    (Kh, Kw), s, p = _pair(K), _pair(stride), _pair(padding)
    _, emin_i, Kph, sp_h = _convt_axis_map(Kh, s[0], p[0], f_in, f_out)
    _, emin_j, Kpw, sp_w = _convt_axis_map(Kw, s[1], p[1], f_in, f_out)
    return {"stride": (sp_h, sp_w), "padding": (-emin_i, -emin_j),
            "kernel": (Kph, Kpw)}


def pack_conv_transpose2d_weight(w, b, *, f_in: int, f_out: int, stride=1,
                                 padding=0):
    """Repack an IOHW (``nn.ConvTranspose2d``) kernel for packed execution.

    The packed op is again a transposed conv: IOHW kernel (f_in^2 Cin,
    f_out^2 Cout, K_p, K_p), stride stride*f_in/f_out, padding -e_min;
    :func:`packed_conv_transpose2d` picks the output padding. The JAX
    package keeps the same kernel as HWIO of a torch-semantics transposed
    conv; ``permute(2, 3, 0, 1)`` maps one to the other, with no flip.
    """
    Cin, Cout, Kh, Kw = w.shape
    s, p = _pair(stride), _pair(padding)
    Mi, _, Kph, _ = _convt_axis_map(Kh, s[0], p[0], f_in, f_out)
    Mj, _, Kpw, _ = _convt_axis_map(Kw, s[1], p[1], f_in, f_out)
    # w_p[(b, g, i), (a, c, o), d, e] = sum_{k,l} Mi[k,a,d,b] Mj[l,c,e,g] w[i,o,k,l]
    w_p = _repack(w, Mi, Mj, "kadb,lceg,iokl->bgiacode",
                  (f_in * f_in * Cin, f_out * f_out * Cout, Kph, Kpw))
    spec = pack_conv_transpose2d_spec((Kh, Kw), f_in=f_in, f_out=f_out,
                                      stride=s, padding=p)
    return w_p, _tile_bias(b, f_out), spec


def packed_conv_transpose2d(x, w_p, b_p, spec, *, out_hw) -> torch.Tensor:
    """Packed transposed conv with the exact output size, through
    ``output_padding`` (JAX :228-243)."""
    sh, sw = spec["stride"]
    ph, pw = spec["padding"]
    Kph, Kpw = spec["kernel"]
    H, W = x.shape[1], x.shape[2]
    op_h = out_hw[0] - ((H - 1) * sh - 2 * ph + Kph)
    op_w = out_hw[1] - ((W - 1) * sw - 2 * pw + Kpw)
    assert 0 <= op_h < max(sh, 1) + 1 and 0 <= op_w < max(sw, 1) + 1, \
        (op_h, op_w)
    b = None if b_p is None else b_p.to(x.dtype)
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w_p.to(x.dtype), b,
                             stride=(sh, sw), padding=(ph, pw),
                             output_padding=(op_h, op_w))
    return out.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# Packed layer math
# ---------------------------------------------------------------------------

def packed_instance_norm(x, f: int, *, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm per original channel over (H, W, phases) of a packed
    (B, Hp, Wp, f*f*C) tensor, equal to the unpacked per-channel
    statistics. Two passes in fp32 (the mean, then the mean squared
    deviation): one-pass statistics drift past the parity bar over the
    generator's 13 norms."""
    B, Hp, Wp, Cp = x.shape
    xf = x.float().reshape(B, -1, Cp // (f * f))
    mean = xf.mean(dim=1, keepdim=True)
    d = xf - mean
    var = d.square().mean(dim=1, keepdim=True)
    return (d * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)


def packed_per_channel_linear(x, w, b, f: int) -> torch.Tensor:
    """An original-channel matmul on every phase: x (..., f*f*Cin) ->
    (..., f*f*Cout); w (Cout, Cin[, 1, 1]) in the PyTorch layout. Equals a
    1x1 conv on the unpacked tensor."""
    Cout, Cin = w.shape[:2]
    t = x.reshape(*x.shape[:-1], f * f, Cin)
    out = F.linear(t, w.reshape(Cout, Cin).to(x.dtype),
                   None if b is None else b.to(x.dtype))
    return out.reshape(*x.shape[:-1], f * f * Cout)


def packed_global_avg_pool(x, f: int) -> torch.Tensor:
    """Global average pool per original channel: (B, Hp, Wp, f*f*C) ->
    (B, C)."""
    B, Hp, Wp, Cp = x.shape
    return x.reshape(B, -1, Cp // (f * f)).mean(dim=1)
