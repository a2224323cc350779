"""Single-image transform pipeline (port of ``pipelines/direct.py``; the
reference's direct_transform.py).

Preprocess: a square Lanczos resize to (size, size) and Normalize(0.5); the
direct pipeline stretches to a square rather than pasting on a canvas
(direct_transform.py:52-59). Postprocess: (x + 1) / 2, clamp, save
(:66-75). Everything runs on the model's device; with ``spatial`` > 1
the generator runs height-sharded over that many devices of the model's
device type (``parallel.spatial``), and the output rows meet on the
model's device. An int8 model (``precision='int8'``) runs its own program,
unsharded: ``spatial`` is not applied to it, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ..ops import from_model_range, resize, to_model_range
from .model_loader import LoadedModel


def _load_rgb(path) -> np.ndarray:
    return np.array(Image.open(path).convert("RGB"), np.uint8)


def _save_rgb(arr01, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    # rounded like torchvision's save_image (mul(255).add_(0.5)): a plain
    # cast would truncate every pixel by half a level on average
    img = np.asarray(np.clip(np.round(np.asarray(arr01) * 255.0), 0, 255),
                     np.uint8)
    Image.fromarray(img).save(path)


def _apply(model: LoadedModel, spatial: int, fast_attention: bool):
    """The generator as ``model.apply``; with ``spatial`` > 1 its
    height-sharded run over that many devices (the local CUDA cards for a
    model on the card, copies of the CPU for one on the CPU), whose output
    shards are joined on the model's device. Too few cards raise. An int8
    model keeps its own program (JAX's pipelines/direct.py:51-55)."""
    if not (spatial and spatial > 1) or model.precision == "int8":
        return model.apply
    from ..parallel.spatial import gather_rows, spatial_apply

    sharded = spatial_apply(model, n_devices=spatial, fast_attention=(
        fast_attention and model.kind == "enhanced"))
    return lambda x: gather_rows(sharded(x), model.device)


def _resized01(model: LoadedModel, image_path, size: int) -> torch.Tensor:
    """The image at ``image_path`` resized to (size, size), in [0, 1], on
    the model's device."""
    img = torch.from_numpy(_load_rgb(image_path)).to(model.device)
    return resize(img.float() / 255.0, (size, size))


def transform_image(model: LoadedModel, image_path, output_path=None,
                    size: int = 256, spatial: int = 0,
                    fast_attention: bool = False) -> np.ndarray:
    """Resize to (size, size), run the generator, return the (size, size, 3)
    [0, 1] float output and save it to ``output_path`` when given.

    ``size`` must be a multiple of 16. ``fast_attention`` is accepted for
    the JAX signature: on a CUDA device the hand-written kernels always
    run. ``spatial`` > 1 runs the generator height-sharded over that many
    devices (``parallel.spatial``), the high-resolution mode for sizes
    whose activations outgrow one card; ``size`` must then be divisible
    by 16 * spatial."""
    apply = _apply(model, spatial, fast_attention)
    x = to_model_range(_resized01(model, image_path, size))[None]
    y = from_model_range(apply(x))[0].float().cpu().numpy()
    if output_path:
        _save_rgb(y, output_path)
    return y


def test_different_sizes(model: LoadedModel, image_path, output_dir,
                         sizes=(128, 256, 512, 768), spatial: int = 0,
                         fast_attention: bool = False) -> str:
    """Size sweep + comparison grid (direct_transform.py:81-118); returns the
    grid's path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    outs = {}
    for s in sizes:
        out_path = os.path.join(output_dir, f"size_{s}.png")
        outs[s] = transform_image(model, image_path, out_path, size=s,
                                  spatial=spatial,
                                  fast_attention=fast_attention)

    fig, axes = plt.subplots(1, len(sizes) + 1,
                             figsize=(4 * (len(sizes) + 1), 4))
    axes[0].imshow(_load_rgb(image_path))
    axes[0].set_title("input")
    axes[0].axis("off")
    for ax, s in zip(axes[1:], sizes):
        ax.imshow(outs[s])
        ax.set_title(f"{s}x{s}")
        ax.axis("off")
    grid_path = os.path.join(output_dir, "size_comparison.png")
    fig.tight_layout()
    fig.savefig(grid_path, dpi=110)
    plt.close(fig)
    return grid_path


def try_skip_connections(model: LoadedModel, image_path, output_dir,
                         blends=(0.5, 0.3, 0.1), size: int = 256,
                         spatial: int = 0,
                         fast_attention: bool = False) -> list:
    """Input-blend ablation (direct_transform.py:120-199): the output blended
    with the resized input at the given shares of the original; returns the
    saved paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    apply = _apply(model, spatial, fast_attention)
    x01_t = _resized01(model, image_path, size)
    y01 = from_model_range(apply(to_model_range(x01_t)[None]))[0]
    x01 = x01_t.cpu().numpy()
    y01 = y01.float().cpu().numpy()

    fig, axes = plt.subplots(1, len(blends) + 2,
                             figsize=(4 * (len(blends) + 2), 4))
    axes[0].imshow(x01); axes[0].set_title("input"); axes[0].axis("off")
    axes[1].imshow(y01); axes[1].set_title("output"); axes[1].axis("off")
    results = []
    for ax, alpha in zip(axes[2:], blends):
        blended = x01 * alpha + y01 * (1 - alpha)
        p = os.path.join(output_dir, f"skip_{int(alpha * 100)}.png")
        _save_rgb(blended, p)
        results.append(p)
        ax.imshow(blended)
        ax.set_title(f"{int(alpha * 100)}% original")
        ax.axis("off")
    grid = os.path.join(output_dir, "skip_comparison.png")
    fig.tight_layout(); fig.savefig(grid, dpi=110); plt.close(fig)
    return results
