"""Validation-SSIM checkpoint selection and soup export on the CUDA device
(the flags of the JAX repo's ``scripts/select_checkpoints.py``).

Scores every saved CycleGAN checkpoint on held-out validation images
against the synthetic domains' closed-form ground truth, per direction:
G_BA(testB photos) vs truth_monet_for_testB and G_AB(testA monets) vs
truth_photo_for_testA. The winner per direction (a single checkpoint, or
the average of the epochs ending at the best one when that scores higher)
goes to --selected_dir in the reference .pth schema as
``G_{AB,BA}_epoch_0.pth``, with ``selection_report.json``.

  python -m multi_style_transfer_gan_tpu_torch.scripts.select_checkpoints \\
      --models_dir runs/models --data_root data/synth_monet2photo \\
      --selected_dir runs/selected --n_val 12
"""

import argparse
import copy
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
from PIL import Image

DEVICE = "cuda"   # tests run the script on the CPU by replacing this


def load_batch(folder, names, size=256):
    arrs = []
    for n in names:
        img = Image.open(os.path.join(folder, n)).convert("RGB")
        if img.size != (size, size):
            img = img.resize((size, size), Image.LANCZOS)
        arrs.append(np.asarray(img, np.uint8))
    return np.stack(arrs)


def make_eval(direction_key, data_root, n_val, holdout_from_end=True):
    """Returns (inputs_u8, truth_u8) for one direction. Validation uses the
    LAST n_val names of the test split (the study's headline metrics use
    the full split)."""
    src = {"BA": "testB", "AB": "testA"}[direction_key]
    truth = {"BA": "truth_monet_for_testB",
             "AB": "truth_photo_for_testA"}[direction_key]
    names = sorted(os.listdir(os.path.join(data_root, src)))
    names = names[-n_val:] if holdout_from_end else names[:n_val]
    return (load_batch(os.path.join(data_root, src), names),
            load_batch(os.path.join(data_root, truth), names))


def forward_u8(model, inputs_u8, batch=8, *, compute_dtype=torch.bfloat16):
    """uint8 (N, H, W, 3) -> uint8 through ``model`` (a ``LoadedModel``) on
    its own device: the input rounded to bf16 in the model range, the
    generator in ``compute_dtype``, back to [0, 1], times 255, clipped and
    truncated to uint8; chunks of ``batch``, the last padded by repeating
    its last image. The process's TF32 switches apply."""
    from ..ops import from_model_range, to_model_range

    module = copy.deepcopy(model.module)
    module = (module.cast_convs_(compute_dtype) if model.kind == "plain"
              else module.to(dtype=compute_dtype))
    outs = []
    with torch.inference_mode():
        for i in range(0, len(inputs_u8), batch):
            chunk = inputs_u8[i:i + batch]
            pad = batch - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
            x = to_model_range(torch.from_numpy(chunk).to(model.device))
            x = x.to(torch.bfloat16).to(compute_dtype)
            y = module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            u8 = torch.clamp(from_model_range(y.float()) * 255.0, 0, 255)
            outs.append(u8.to(torch.uint8).cpu().numpy()[:batch - pad])
    return np.concatenate(outs)


def mean_ssim(outs_u8, truth_u8, device):
    """The mean of the per-image SSIMs (``compare_pair`` on ``device``)."""
    from ..metrics.quality import compare_pair

    a, b = (torch.from_numpy(np.ascontiguousarray(u8)).to(device).float()
            / 255.0 for u8 in (outs_u8, truth_u8))
    vals = compare_pair(a, b)["ssim"].tolist()
    return float(np.mean(vals))


def soup_state_dict(paths, key):
    """Average the generator tensors of several checkpoints in fp32 on the
    host (InstanceNorm networks average cleanly); exported as torch
    tensors."""
    from ..weights import extract_state_dict, load_pth

    sds = [extract_state_dict(load_pth(p), prefer=key) for p in paths]
    avg = {}
    for k in sds[0]:
        stack = np.stack([np.asarray(sd[k].numpy(), np.float32) for sd in sds])
        avg[k] = torch.from_numpy(stack.mean(0))
    return avg


def apply_from_sd(sd, *, device):
    """A ``LoadedModel`` of the enhanced state dict ``sd`` on ``device``."""
    from ..pipelines import model_from_state_dict

    return model_from_state_dict(sd, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models_dir", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--selected_dir", required=True)
    ap.add_argument("--n_val", type=int, default=12)
    ap.add_argument("--soup_max", type=int, default=8,
                    help="the soup averages the top-k window of epochs "
                         "ending at the best single checkpoint")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..pipelines import load_generator
    from ..weights import load_pth

    epochs = sorted({int(p.stem.split("_")[-1])
                     for p in Path(args.models_dir).glob("G_AB_epoch_*.pth")})
    print(f"checkpoints: epochs {epochs}")
    report = {"epochs": epochs, "per_direction": {}}
    selected = {}
    for key in ("BA", "AB"):
        inputs, truth = make_eval(key, args.data_root, args.n_val)
        null_ssim = mean_ssim(inputs, truth, DEVICE)
        rows = []
        for e in epochs:
            path = os.path.join(args.models_dir, f"G_{key}_epoch_{e}.pth")
            model = load_generator(path, prefer=f"G_{key}_state_dict",
                                   device=DEVICE)
            s = mean_ssim(forward_u8(model, inputs), truth, DEVICE)
            rows.append({"epoch": e, "ssim": round(s, 4)})
            print(f"G_{key} epoch {e}: val SSIM {s:.4f}", flush=True)
        best = max(rows, key=lambda r: r["ssim"])
        # soup: average the up-to-soup_max epochs ENDING at the best one
        idx = next(i for i, r in enumerate(rows)
                   if r["epoch"] == best["epoch"])
        window = [r["epoch"] for r in rows[max(0, idx - args.soup_max + 1)
                                           : idx + 1]]
        soup_paths = [os.path.join(args.models_dir,
                                   f"G_{key}_epoch_{e}.pth")
                      for e in window]
        soup_sd = soup_state_dict(soup_paths, f"G_{key}_state_dict")
        soup_ssim = mean_ssim(
            forward_u8(apply_from_sd(soup_sd, device=DEVICE), inputs), truth,
            DEVICE)
        print(f"G_{key} soup({window}): val SSIM {soup_ssim:.4f} "
              f"(best single {best['ssim']} @ {best['epoch']}; "
              f"identity {null_ssim:.4f})")
        pick_soup = soup_ssim > best["ssim"]
        report["per_direction"][key] = {
            "curve": rows, "identity_ssim": round(null_ssim, 4),
            "best_single": best,
            "soup": {"epochs": window, "ssim": round(soup_ssim, 4)},
            "selected": "soup" if pick_soup else f"epoch_{best['epoch']}",
        }
        if pick_soup:
            selected[key] = {f"G_{key}_state_dict": soup_sd,
                             "epoch": best["epoch"]}
        else:
            src = load_pth(soup_paths[-1])
            selected[key] = {f"G_{key}_state_dict":
                             src[f"G_{key}_state_dict"],
                             "epoch": best["epoch"]}

    os.makedirs(args.selected_dir, exist_ok=True)
    for key, ckpt in selected.items():
        out = os.path.join(args.selected_dir, f"G_{key}_epoch_0.pth")
        torch.save(ckpt, out)
        print(f"exported {out}")
    with open(os.path.join(args.selected_dir, "selection_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v["selected"]
                      for k, v in report["per_direction"].items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
