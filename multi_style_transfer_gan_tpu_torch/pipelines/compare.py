"""Compare pipeline, the enhanced model beside the plain CycleGAN on one input
(port of ``pipelines/compare.py``; the reference GUI's compare tab,
gan_login_gui.py:2423-2638).

The enhanced model goes through the local-style ``enhanced`` post chain at
the tab's fixed detail of 0.6, the CycleGAN model runs on the same canvas,
and a figure shows the original and both results side by side. Both
models' work runs on their devices.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ..ops import from_model_range, restore_aspect, to_model_range
from .batch import _decode_canvas, _postprocess
from .model_loader import LoadedModel


def compare_models(enhanced: LoadedModel, cyclegan: LoadedModel, img_path,
                   output_dir, strength: float = 0.8,
                   detail: float = 0.6) -> dict:
    """Returns {enhanced, cyclegan, figure}: the paths written (the original
    is shown in the figure, not saved again)."""
    os.makedirs(output_dir, exist_ok=True)
    canvas, (w, h) = _decode_canvas(img_path, canvas=256, fill=255)
    canvas = np.array(canvas)   # writable, for torch.from_numpy

    def styled255(model):
        x = to_model_range(torch.from_numpy(canvas).to(model.device))[None]
        return from_model_range(model.apply(x).float()) * 255.0

    batch_f = torch.from_numpy(canvas).to(enhanced.device).float()[None]
    enh_out = _postprocess(batch_f, styled255(enhanced), "enhanced",
                           strength, detail, True, True)[0]
    cyc_out = styled255(cyclegan)[0]

    def finish(arr255, name):
        u8 = torch.clamp(torch.round(arr255), 0, 255).to(torch.uint8)
        img = restore_aspect(u8.cpu().numpy(), (w, h), 256)
        p = os.path.join(output_dir, f"compare_{name}.png")
        img.save(p)
        return p, img

    p_enh, img_enh = finish(enh_out, "enhanced")
    p_cyc, img_cyc = finish(cyc_out, "cyclegan")

    from ..utils.figures import have_matplotlib, panel_grid

    orig = Image.open(img_path).convert("RGB")
    panels = [(orig, "original"), (img_enh, "enhanced local-style"),
              (img_cyc, "cyclegan")]
    figure_path = os.path.join(output_dir, "compare_side_by_side.png")
    if not have_matplotlib():
        panel_grid(panels, 3, figure_path)
        return {"enhanced": p_enh, "cyclegan": p_cyc, "figure": figure_path}
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for ax, (im, title) in zip(axes, panels):
        ax.imshow(np.asarray(im))
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(figure_path, dpi=110)
    plt.close(fig)
    return {"enhanced": p_enh, "cyclegan": p_cyc, "figure": figure_path}
