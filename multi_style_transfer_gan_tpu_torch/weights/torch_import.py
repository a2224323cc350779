"""``.pth`` checkpoint sniffing, conversion and inspection (port of
``weights/torch_import.py``).

The port's modules carry the reference's ``state_dict()`` keys and
layouts, so a checkpoint loads as it is; only the converters from the JAX
package's parameters (HWIO kernels, spectral-norm v in (kh, kw, I) order)
transpose anything.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# Checkpoint container keys, in sniffing order (the reference's
# convert_model.py:12-29 plus the legacy G_A/G_B pair).
_STATE_DICT_KEYS = (
    "G_AB_state_dict", "G_BA_state_dict", "G_A", "G_B",
    "state_dict", "model_state_dict",
    "D_A_state_dict", "D_B_state_dict",
)

# Transposed-conv weights (IOHW in PyTorch), per model family.
_PLAIN_TRANSPOSED = {"decoder.0", "decoder.3", "decoder.6", "decoder.9"}
_ENH_TRANSPOSED = {"up1.0", "up2.0"}
_TRANSPOSED = {"plain": _PLAIN_TRANSPOSED, "enhanced": _ENH_TRANSPOSED}


def load_pth(path):
    """Load a ``.pth`` file onto the CPU (tensors and plain containers)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def extract_state_dict(ckpt, prefer: str | None = None) -> dict:
    """The flat state dict of any reference checkpoint flavor.

    ``prefer`` selects one container key (e.g. ``"G_AB_state_dict"``);
    otherwise the first present key of the sniffing order wins, and a bare
    state dict passes through with ``epoch`` / ``G_*`` metadata dropped.
    """
    if not isinstance(ckpt, dict):
        raise ValueError(f"unsupported checkpoint object: {type(ckpt)}")
    if prefer is not None:
        if prefer not in ckpt:
            raise KeyError(f"checkpoint has no '{prefer}' "
                           f"(keys: {list(ckpt)[:8]})")
        sd = ckpt[prefer]
    else:
        sd = next((ckpt[k] for k in _STATE_DICT_KEYS if k in ckpt), None)
        if sd is None:
            sd = {k: v for k, v in ckpt.items()
                  if k != "epoch" and not k.startswith("G_")
                  and hasattr(v, "shape")}
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def detect_model_kind(sd) -> str:
    """'plain' (encoder/decoder Generator), 'enhanced' or 'discriminator'."""
    if any(k.startswith("encoder.") for k in sd):
        return "plain"
    if any(k.startswith("initial.") for k in sd):
        return "enhanced"
    if any(k.startswith("main.") for k in sd):
        return "discriminator"
    raise ValueError(f"unrecognized state dict (keys: {list(sd)[:8]})")


def detect_channels(sd) -> int:
    """Channel width of the first conv, like the reference's
    direct_transform.py:25-30."""
    kind = detect_model_kind(sd)
    if kind == "plain":
        return int(sd["encoder.0.weight"].shape[0])
    if kind == "enhanced":
        return int(sd["initial.0.weight"].shape[0])
    key = "main.0.weight_orig" if "main.0.weight_orig" in sd else "main.0.weight"
    return int(sd[key].shape[0])


def state_dict_from_jax_params(params: dict, kind: str = "enhanced") -> dict:
    """Generator parameters of the JAX package (HWIO conv kernels, (out, in)
    linear weights) -> a PyTorch state dict; ``kind`` is "enhanced" or
    "plain" (the discriminator's converter passes "discriminator", which
    has no transposed conv).

    Conv kernels go HWIO -> OIHW, the family's transposed convs (``up1.0``
    and ``up2.0``; ``decoder.{0,3,6,9}``) HWIO -> IOHW, everything else
    keeps its layout. Every BatchNorm gets the ``num_batches_tracked`` the
    JAX parameters do not carry (0), so a strict load takes the result.
    """
    transposed = _TRANSPOSED.get(kind, set())
    sd = {}
    for k, v in params.items():
        arr = np.asarray(v)
        if arr.ndim == 4:
            prefix = k.rsplit(".", 1)[0]
            perm = (2, 3, 0, 1) if prefix in transposed else (3, 2, 0, 1)
            arr = arr.transpose(perm)
        sd[k] = torch.tensor(np.ascontiguousarray(arr))  # a copy, writable
        if k.endswith(".running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return sd


def discriminator_state_dict_from_jax(params: dict, sn_state: dict) -> dict:
    """EnhancedDiscriminator parameters and ``sn_state`` of the JAX package
    -> the port's (and torch's) state dict.

    ``weight_orig`` goes HWIO -> OIHW. ``weight_u`` is taken as it is.
    ``weight_v`` goes from the JAX flat (kh, kw, I) order back to torch's
    (I, kh, kw), the inverse of ``_convert_weight_v``
    (weights/torch_import.py:138-143). A v of None (before the first power
    iteration) is synthesized as v = normalize(W^T u), as the JAX
    ``save_models`` does (train/cyclegan.py:300-307).
    """
    sd = state_dict_from_jax_params(params, "discriminator")
    for name, st in sn_state.items():
        w = np.asarray(params[f"{name}.weight_orig"], np.float32)  # HWIO
        kh, kw, i, _ = w.shape
        u = np.asarray(st["u"], np.float32)
        if st.get("v") is not None:
            v = np.asarray(st["v"], np.float32).reshape(kh, kw, i)
        else:
            v_flat = w.reshape(-1, w.shape[-1]) @ u
            v = (v_flat / max(np.linalg.norm(v_flat), 1e-12)).reshape(kh, kw, i)
        sd[f"{name}.weight_u"] = torch.tensor(u)
        sd[f"{name}.weight_v"] = torch.tensor(
            np.ascontiguousarray(v.transpose(2, 0, 1).reshape(-1)))
    return sd


def vgg16_state_dict_from_jax(params: dict) -> dict:
    """The JAX package's VGG16 trunk parameters (``conv{idx}.weight`` HWIO,
    ``conv{idx}.bias``; ``train/perceptual.py``) -> a torchvision-format
    ``vgg16`` state dict (``features.{idx}.weight`` OIHW), which
    ``train.perceptual.vgg16_from_torchvision_sd`` takes."""
    sd = {}
    for k, v in params.items():
        idx, name = k[len("conv"):].split(".")
        arr = np.asarray(v)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        sd[f"features.{idx}.{name}"] = torch.tensor(np.ascontiguousarray(arr))
    return sd


def save_pth(obj, path):
    """``torch.save`` of ``obj`` with numpy arrays (at any depth of nested
    dicts) turned into tensors; creates the file's directory."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            return torch.tensor(np.ascontiguousarray(v))   # a writable copy
        return v

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(conv(obj), path)


def convert_model(input_path, output_path) -> bool:
    """CLI parity with the reference's convert_model.py: any checkpoint
    flavor -> a flat state-dict ``.pth``. Prints what it did; a failure is
    printed and returned as False, as the reference's tolerant CLI does."""
    try:
        sd = extract_state_dict(load_pth(input_path))
        save_pth(sd, output_path)
        print(f"model converted and saved to {output_path}")
        return True
    except Exception as e:  # mirror the reference's tolerant CLI behavior
        print(f"conversion failed: {e}")
        return False


def pth_info(path) -> list[str]:
    """Print ``name: shape`` for every tensor of the checkpoint's state dict
    (the reference's pth_info.py); returns the lines."""
    sd = extract_state_dict(load_pth(path))
    lines = [f"{k}: {tuple(v.shape)}" for k, v in sd.items()]
    for line in lines:
        print(line)
    return lines
