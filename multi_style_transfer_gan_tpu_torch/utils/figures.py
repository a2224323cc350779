"""Figures drawn with PIL alone, for hosts without matplotlib (the card's
machine has none): titled image panels in a grid and a grouped bar chart,
written to the same paths the matplotlib figures take. Where matplotlib
imports, the pipelines draw with it as the JAX package does."""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw, ImageFont

_TITLE = 22       # pixels of the title strip above each panel
_PAD = 8
_COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
           (148, 103, 189), (140, 86, 75))


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _rgb(image) -> Image.Image:
    """A PIL image, a uint8 array or a [0, 1] float array (a 2-D map in
    grey) as an RGB PIL image."""
    if isinstance(image, Image.Image):
        return image.convert("RGB")
    a = np.asarray(image)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, -1)
    return Image.fromarray(a).convert("RGB")


def panel_grid(panels, cols: int, path, **save_kw) -> None:
    """``panels``: (image, title) pairs, laid out ``cols`` across in cells of
    the largest panel's size, each title above its image."""
    images = [(_rgb(im), title) for im, title in panels]
    cw = max(im.width for im, _ in images) + 2 * _PAD
    ch = max(im.height for im, _ in images) + _TITLE + _PAD
    rows = -(-len(images) // cols)
    fig = Image.new("RGB", (cols * cw, rows * ch), "white")
    draw = ImageDraw.Draw(fig)
    font = ImageFont.load_default()
    for i, (im, title) in enumerate(images):
        x, y = (i % cols) * cw, (i // cols) * ch
        draw.text((x + _PAD, y + 4), title or "", fill="black", font=font)
        fig.paste(im, (x + (cw - im.width) // 2, y + _TITLE))
    fig.save(path, **save_kw)


def bar_chart(path, labels, series, title: str, ylabel: str) -> None:
    """Grouped bars: one group per label, one bar per series, from 0 to
    the largest value; the title, the y label, the series in a legend."""
    labels = list(labels)
    names = list(series)
    values = np.asarray([series[n] for n in names], np.float64)
    w, h, left, top, bottom = 720, 480, 70, 40, 80
    fig = Image.new("RGB", (w, h), "white")
    draw = ImageDraw.Draw(fig)
    font = ImageFont.load_default()
    draw.text((left, 12), title, fill="black", font=font)
    draw.text((6, top), ylabel, fill="black", font=font)
    plot_w, plot_h = w - left - 20, h - top - bottom
    peak = float(np.nanmax(np.abs(values))) if values.size else 0.0
    scale = plot_h / peak if peak > 0 else 0.0
    base = top + plot_h
    draw.line((left, top, left, base, w - 20, base), fill="black")
    draw.text((left - 60, top - 6), f"{peak:.4g}", fill="black", font=font)
    group = plot_w / max(len(labels), 1)
    bar = 0.8 * group / max(len(names), 1)
    for g, label in enumerate(labels):
        x0 = left + g * group + 0.1 * group
        for s, name in enumerate(names):
            v = float(values[s, g])
            top_y = base - max(v, 0.0) * scale
            draw.rectangle((x0 + s * bar, top_y, x0 + (s + 1) * bar - 1, base),
                           fill=_COLORS[s % len(_COLORS)])
        draw.text((x0, base + 6), str(label), fill="black", font=font)
    for s, name in enumerate(names):
        y = h - bottom + 30 + 14 * s
        draw.rectangle((left, y, left + 10, y + 10),
                       fill=_COLORS[s % len(_COLORS)])
        draw.text((left + 16, y - 1), str(name), fill="black", font=font)
    fig.save(path)
