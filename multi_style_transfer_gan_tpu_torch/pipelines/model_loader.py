"""Checkpoint -> ready-to-run generator (port of
``pipelines/model_loader.py``).

Sniffs the checkpoint flavor (G_AB, G_BA or raw), the model family and the
channel width, builds the ``nn.Module`` and loads the weights with
``strict=True``: the module's keys are the checkpoint's, so nothing is
converted. The serving kernels take every EnhancedGenerator width, so no
width is refused here; a model that outgrows the card's memory raises
PyTorch's own out-of-memory error. ``precision='int8'`` serves an enhanced
model through the EXPERIMENTAL int8 engine (``QuantizedEnhancedGenerator``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..models import (
    EnhancedGenerator, PlainGenerator, channels_of, num_transformer_blocks_of,
    prepare_int8_model,
)
from ..models.quantized_generator import EXPERIMENTAL_WARNING
from ..weights import (
    detect_channels, detect_model_kind, extract_state_dict, load_pth,
)

PRECISIONS = ("default", "high", "highest", "int8")


@dataclass
class LoadedModel:
    kind: str                  # "plain" | "enhanced"
    channels: int
    direction: str | None      # "AB" | "BA" | None (from the checkpoint key)
    module: nn.Module          # fp32 weights, eval mode, channels_last
    apply: Callable            # apply(x: (B, H, W, 3) in [-1, 1]) -> same
                               # (bf16 for precision 'int8')
    precision: str = "default"

    @property
    def device(self) -> torch.device:
        """The device the weights live on, where ``apply`` takes its input."""
        return next(self.module.parameters()).device


def _sniff_direction(ckpt, prefer: str | None = None) -> str | None:
    if isinstance(ckpt, dict):
        # a dual checkpoint holds both generators: report the one asked for
        if prefer and prefer in ckpt and "state_dict" in prefer:
            return "BA" if "BA" in prefer else "AB"
        if "G_AB_state_dict" in ckpt:
            return "AB"
        if "G_BA_state_dict" in ckpt:
            return "BA"
    return None


def load_generator(path, prefer: str | None = None,
                   precision: str = "default", calib_batches=None, *,
                   device) -> LoadedModel:
    """Load a reference-flavor generator checkpoint onto ``device``.

    precision: "default" and "high" run fp32 convolutions as PyTorch's
    settings allow (cuDNN may use TF32 on the card); "highest" turns TF32
    off inside ``apply``, the counterpart of JAX's precision='highest';
    "int8" (enhanced models only, ValueError otherwise) makes ``apply`` the
    int8 engine, calibrated on ``calib_batches`` ((B, H, W, 3) arrays in
    [-1, 1]; None: ``prepare_int8_model``'s seeded synthetic batch), whose
    output is bf16.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    ckpt = load_pth(path)
    sd = extract_state_dict(ckpt, prefer=prefer)
    return model_from_state_dict(sd, precision=precision,
                                 direction=_sniff_direction(ckpt, prefer),
                                 calib_batches=calib_batches, device=device)


def model_from_state_dict(sd, precision: str = "default",
                          direction: str | None = None, calib_batches=None,
                          *, device) -> LoadedModel:
    """A generator state dict (plain or enhanced) -> ``LoadedModel`` on
    ``device``, as :func:`load_generator` builds it from a file."""
    kind = detect_model_kind(sd)
    if kind == "plain":
        module = PlainGenerator(detect_channels(sd))
    elif kind == "enhanced":
        module = EnhancedGenerator(channels_of(sd),
                                   num_transformer_blocks_of(sd))
    else:
        raise ValueError(f"the checkpoint is a {kind}, not a generator")
    if precision == "int8" and kind != "enhanced":
        raise ValueError("precision='int8' supports enhanced models only")
    module.load_state_dict(sd, strict=True)
    module = module.to(device=device, memory_format=torch.channels_last).eval()
    if precision == "int8":
        print(EXPERIMENTAL_WARNING)
        int8 = prepare_int8_model(module, calib_batches)

        def apply_int8(x):
            with torch.inference_mode():
                return int8(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        return LoadedModel(kind=kind, channels=detect_channels(sd),
                           direction=direction, module=module,
                           apply=apply_int8, precision=precision)

    def apply(x):
        # TF32 by ``precision``; cuDNN's other switches as the caller set
        # them (``deterministic`` makes two forwards bit-equal on the card)
        cudnn = torch.backends.cudnn
        with torch.inference_mode(), cudnn.flags(
                enabled=True, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic,
                allow_tf32=precision != "highest"):
            y = module(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)

    return LoadedModel(kind=kind, channels=detect_channels(sd),
                       direction=direction, module=module, apply=apply,
                       precision=precision)
