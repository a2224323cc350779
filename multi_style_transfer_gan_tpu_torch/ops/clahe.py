"""CLAHE, contrast-limited adaptive histogram equalization, cv2-compatible
(port of ``ops/clahe.py``).

Per cv2: a 256-bin histogram per tile, clipped at ``clipLimit * tile_pixels
/ 256`` (at least 1) with the clipped excess redistributed as cv2 does, a
LUT per tile from the cdf, then at every pixel a bilinear blend of the four
surrounding tiles' LUT values. Batched; the histograms are one exact
integer ``bincount``.
"""

from __future__ import annotations

import torch

from .filters import batched_hist256


def clahe(gray_u8, clip_limit: float = 2.0, grid: int = 8) -> torch.Tensor:
    """gray_u8: (..., H, W) uint8-scale floats, H and W divisible by
    ``grid`` (cv2 pads otherwise; the callers use 256 x 256 inputs)."""
    x = torch.clamp(torch.round(gray_u8.float()), 0, 255)
    batched = x.ndim == 3
    if not batched:
        x = x[None]
    B, H, W = x.shape
    th, tw = H // grid, W // grid
    npx = th * tw
    dev = x.device

    tiles = x.reshape(B, grid, th, grid, tw).permute(0, 1, 3, 2, 4)
    hist = batched_hist256(tiles.reshape(-1, npx)).reshape(
        B, grid * grid, 256).float()

    # cv2: clipLimit = max(int(clip * npx / 256), 1); the clipped excess goes
    # to every bin in whole shares, then +1 to bins at stride
    # max(256 // residual, 1) until the residual is spent
    limit = float(max(int(clip_limit * npx / 256.0), 1))
    clipped = torch.clamp(hist, max=limit)
    excess = torch.sum(hist - clipped, dim=-1, keepdim=True)
    redist = torch.floor(excess / 256.0)
    residual = excess - redist * 256.0
    step = torch.clamp(torch.floor(256.0 / torch.clamp(residual, min=1.0)),
                       min=1.0)
    i = torch.arange(256, dtype=torch.float32, device=dev)[None, None, :]
    bump = ((torch.remainder(i, step) == 0)
            & (torch.floor(i / step) < residual)).float()
    hist = clipped + redist + bump

    cdf = torch.cumsum(hist, dim=-1)
    luts = torch.clamp(torch.round(cdf * (255.0 / npx)), 0, 255)  # (B, T, 256)

    # bilinear between the tile LUTs (cv2: tile coordinate x / tw - 0.5 at
    # integer pixel coordinates; weights taken before the tile indices are
    # clamped)
    ty = torch.arange(H, dtype=torch.float32, device=dev) / th - 0.5
    tx = torch.arange(W, dtype=torch.float32, device=dev) / tw - 0.5
    y0f, x0f = torch.floor(ty), torch.floor(tx)
    wy = (ty - y0f)[:, None]
    wx = (tx - x0f)[None, :]
    y0 = torch.clamp(y0f, 0, grid - 1).long()
    x0 = torch.clamp(x0f, 0, grid - 1).long()
    y1 = torch.clamp(y0f + 1, 0, grid - 1).long()
    x1 = torch.clamp(x0f + 1, 0, grid - 1).long()

    pix = x.long().reshape(B, H * W)
    luts_flat = luts.reshape(B, grid * grid * 256)

    def lut_at(yi, xi):
        # the LUT of tile (yi[y], xi[x]) at each pixel's value
        tile = (yi[:, None] * grid + xi[None, :]).reshape(1, H * W)
        return torch.gather(luts_flat, 1, tile * 256 + pix).reshape(B, H, W)

    v00 = lut_at(y0, x0)
    v01 = lut_at(y0, x1)
    v10 = lut_at(y1, x0)
    v11 = lut_at(y1, x1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    out = torch.clamp(torch.round(out), 0, 255)
    return out if batched else out[0]
