"""Window relayout, NHWC <-> packed rows: CUDA kernel and plain version.

``space_to_depth_plain`` and ``depth_to_space_plain`` are the port of
``ops/packed.py::space_to_depth`` / ``depth_to_space``: (B, H, W, C) <->
(B, H/f, W/f, f*f*C) in the JAX channel order (pi, pj, c), phase major.
(``torch.nn.functional.pixel_unshuffle`` orders channels (c, pi, pj) and is
not this layout.) ``window_relayout`` launches ``csrc/window_relayout.cu``,
which replaces the Pallas ``s2d_rows`` / ``d2s_rows``
(``ops/pallas/window_relayout.py``).
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import check_cuda_args, check_no_grad


def space_to_depth_plain(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, f*f*C), channel order (pi, pj, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // f, f, W // f, f, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // f, W // f, f * f * C)


def depth_to_space_plain(x: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth_plain`."""
    B, Hp, Wp, Cp = x.shape
    C = Cp // (f * f)
    x = x.reshape(B, Hp, Wp, f, f, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp * f, Wp * f, C)


def window_relayout(x: torch.Tensor, f: int = 4, *,
                    inverse: bool = False) -> torch.Tensor:
    """space_to_depth of a (B, H, W, C) tensor, or with ``inverse`` the
    depth_to_space of a (B, Hp, Wp, f*f*C) one. Returns a contiguous tensor.

    A CPU tensor takes the plain version. A CUDA tensor (contiguous, fp32 or
    bf16) launches the copy kernel or raises, also on a call that autograd
    would record (the kernel's output carries no gradient).
    """
    B, H, W, C = x.shape
    if inverse:
        if C % (f * f):
            raise ValueError(f"depth_to_space: {C} channels do not split "
                             f"into {f}x{f} phases")
        C //= f * f
        H, W = H * f, W * f
        out_shape = (B, H, W, C)
    else:
        if H % f or W % f:
            raise ValueError(f"space_to_depth: {H}x{W} is not divisible "
                             f"by {f}")
        out_shape = (B, H // f, W // f, f * f * C)
    if x.device.type == "cpu":
        plain = depth_to_space_plain if inverse else space_to_depth_plain
        return plain(x, f).contiguous()
    check_no_grad("window_relayout", x)
    check_cuda_args("window_relayout", x, {})
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if x.numel():
        rc = _build.kernel("window_relayout")(
            x.data_ptr(), y.data_ptr(), B, H, W, C, f, x.element_size(),
            int(not inverse), x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"window_relayout launch failed: CUDA error "
                               f"{rc}")
        window_relayout.launches += 1
    return y


window_relayout.launches = 0
