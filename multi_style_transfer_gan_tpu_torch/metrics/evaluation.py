"""Folder-vs-folder quality evaluation (port of ``metrics/evaluation.py``).

The capability surface of the reference's compare_image_quality.py
(base-vs-many folders with name-intersection matching :35-59, sibling
folder discovery :517-530, the identical-image guard :309-311, the
invalid-metric skip :323-329, Excel and bar-chart outputs :380-467),
complete_comparison.py (three-folder win counts, verdict, multi-sheet
Excel) and prepare_comparison_folders.py.

Images decode on the host (PIL, LANCZOS where sizes differ); the pairs are
bucketed by the base image's size and their metrics computed on ``device``
one batch at a time.
"""

from __future__ import annotations

import os
import shutil
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..data import list_images
from .quality import check_metrics_device, compare_pair
from .report import comparison_bar_chart, write_xlsx


def find_matching_images(base_dir, other_dir) -> list[str]:
    """Filename-intersection matching (compare_image_quality.py:35-59)."""
    base = {os.path.basename(p) for p in list_images(base_dir)}
    other = {os.path.basename(p) for p in list_images(other_dir)}
    return sorted(base & other)


def _load_pair(a_path, b_path, size=None):
    a = Image.open(a_path).convert("RGB")
    b = Image.open(b_path).convert("RGB")
    if a.size != b.size:
        b = b.resize(a.size, Image.LANCZOS)  # resize-to-match (:20-23)
    if size is not None and a.size != size:
        a = a.resize(size, Image.LANCZOS)
        b = b.resize(size, Image.LANCZOS)
    return (np.asarray(a, np.float32) / 255.0,
            np.asarray(b, np.float32) / 255.0)


def compare_folder_pair(base_dir, other_dir, batch: int = 16, *,
                        device) -> dict:
    """Per-image and average MSE/PSNR/SSIM between matching files.

    Returns {"per_image": {name: {mse, psnr, ssim}}, "average": {...},
    "skipped": [(name, why)]}. ``device``'s SSIM is first held to the
    CPU's (``check_metrics_device``, which raises on a disagreement).
    """
    check_metrics_device(device)
    names = find_matching_images(base_dir, other_dir)
    # bucket by the BASE image's size from the PIL header alone: decoding
    # happens per device chunk, so a folder of thousands of images never
    # holds more than one batch of floats in host memory
    buckets: dict = defaultdict(list)
    for n in names:
        with Image.open(os.path.join(base_dir, n)) as im:
            buckets[im.size].append(n)

    per_image, skipped = {}, []
    for items in buckets.values():
        for i in range(0, len(items), batch):
            chunk = items[i:i + batch]
            pairs = [_load_pair(os.path.join(base_dir, n),
                                os.path.join(other_dir, n)) for n in chunk]
            a = torch.from_numpy(np.stack([p[0] for p in pairs])).to(device)
            b = torch.from_numpy(np.stack([p[1] for p in pairs])).to(device)
            out = {k: v.cpu().numpy() for k, v in compare_pair(a, b).items()}
            for j, n in enumerate(chunk):
                m = {k: float(v[j]) for k, v in out.items()}
                # identical-image guard (:309-311), invalid skip (:323-329)
                if m["mse"] == 0.0:
                    skipped.append((n, "identical images"))
                    continue
                if not all(np.isfinite(list(m.values()))):
                    skipped.append((n, "invalid metric"))
                    continue
                per_image[n] = m
    avg = {}
    if per_image:
        for k in ("mse", "psnr", "ssim"):
            avg[k] = float(np.mean([m[k] for m in per_image.values()]))
    return {"per_image": per_image, "average": avg, "skipped": skipped}


def auto_detect_folders(base_dir) -> list[str]:
    """Sibling-folder discovery (:517-530): folders next to ``base_dir``
    that contain images."""
    parent = Path(base_dir).resolve().parent
    out = []
    for d in sorted(parent.iterdir()):
        if d.is_dir() and str(d) != str(Path(base_dir).resolve()):
            if list_images(d):
                out.append(str(d))
    return out


def compare_image_quality(base_dir, other_dirs=None,
                          output_prefix="comparison", output_dir=".",
                          auto_detect=False, *, device) -> dict:
    """Multi-folder comparison with Excel and chart outputs
    (compare_image_quality.py's main surface)."""
    # auto_detect REPLACES any explicit list, as the reference does
    # (compare_image_quality.py:517-530 rebuilds comparison_folders from
    # the siblings whenever --auto_detect is set)
    if auto_detect or not other_dirs:
        other_dirs = auto_detect_folders(base_dir)
    results = {}
    for d in other_dirs:
        key = os.path.basename(os.path.normpath(d))
        if key in results:  # two dirs with the same basename: disambiguate
            key = os.path.join(
                os.path.basename(os.path.dirname(os.path.normpath(d))), key)
        results[key] = compare_folder_pair(base_dir, d, device=device)

    os.makedirs(output_dir, exist_ok=True)
    detailed = [["folder", "image", "mse", "psnr", "ssim"]]
    summary = [["folder", "images", "avg_mse", "avg_psnr", "avg_ssim"]]
    for name, res in results.items():
        for img, m in res["per_image"].items():
            detailed.append([name, img, m["mse"], m["psnr"], m["ssim"]])
        if res["average"]:
            summary.append([name, len(res["per_image"]), res["average"]["mse"],
                            res["average"]["psnr"], res["average"]["ssim"]])
    xlsx = os.path.join(output_dir, f"{output_prefix}_results.xlsx")
    write_xlsx(xlsx, {"Detailed": detailed, "Summary": summary})

    labels = [r[0] for r in summary[1:]]
    if labels:
        for metric, col in (("mse", 2), ("psnr", 3), ("ssim", 4)):
            comparison_bar_chart(
                os.path.join(output_dir, f"{output_prefix}_{metric}_chart.png"),
                labels, {metric: [r[col] for r in summary[1:]]},
                f"Average {metric.upper()} vs {os.path.basename(base_dir)}",
                metric.upper())
    return {"results": results, "xlsx": xlsx}


def complete_comparison(original_dir, folder_a, folder_b,
                        name_a="cyclegan", name_b="localstyle",
                        output_dir=".", *, device) -> dict:
    """Three-folder study with per-metric win counts and a verdict
    (complete_comparison.py:34-429)."""
    res_a = compare_folder_pair(original_dir, folder_a, device=device)
    res_b = compare_folder_pair(original_dir, folder_b, device=device)
    common = sorted(set(res_a["per_image"]) & set(res_b["per_image"]))

    wins = {name_a: {"mse": 0, "psnr": 0, "ssim": 0},
            name_b: {"mse": 0, "psnr": 0, "ssim": 0}}
    detailed = [["image",
                 f"{name_a}_mse", f"{name_b}_mse",
                 f"{name_a}_psnr", f"{name_b}_psnr",
                 f"{name_a}_ssim", f"{name_b}_ssim"]]
    for n in common:
        ma, mb = res_a["per_image"][n], res_b["per_image"][n]
        detailed.append([n, ma["mse"], mb["mse"], ma["psnr"], mb["psnr"],
                        ma["ssim"], mb["ssim"]])
        # ties credit name_b, as the reference's else-branch does
        # (complete_comparison.py:185-199)
        wins[name_a if ma["mse"] < mb["mse"] else name_b]["mse"] += 1
        wins[name_a if ma["psnr"] > mb["psnr"] else name_b]["psnr"] += 1
        wins[name_a if ma["ssim"] > mb["ssim"] else name_b]["ssim"] += 1

    n = max(len(common), 1)
    win_rows = [["metric", f"{name_a}_wins", f"{name_b}_wins",
                 f"{name_b}_win_rate"]]
    for k in ("mse", "psnr", "ssim"):
        win_rows.append([k, wins[name_a][k], wins[name_b][k],
                         100.0 * wins[name_b][k] / n])
    total_b = sum(wins[name_b].values())
    if not common:
        verdict = "no matching images to compare"
    elif total_b >= 3 * n / 2:
        verdict = f"{name_b} wins {total_b}/{3 * n} metric comparisons"
    else:
        verdict = f"{name_a} wins {3 * n - total_b}/{3 * n} metric comparisons"

    summary = [["folder", "avg_mse", "avg_psnr", "avg_ssim"]]
    for nm, r in ((name_a, res_a), (name_b, res_b)):
        if r["average"]:
            summary.append([nm, r["average"]["mse"], r["average"]["psnr"],
                            r["average"]["ssim"]])
    os.makedirs(output_dir, exist_ok=True)
    xlsx = os.path.join(output_dir, "detailed_metrics_comparison.xlsx")
    write_xlsx(xlsx, {"Detailed Comparison": detailed,
                      "Summary": summary,
                      "Win Statistics": win_rows})
    if len(summary) > 1:
        comparison_bar_chart(
            os.path.join(output_dir, "comparison_results_charts.png"),
            ["mse", "psnr", "ssim"],
            {row[0]: row[1:] for row in summary[1:]},
            "Quality comparison", "value")
    return {"wins": wins, "verdict": verdict, "xlsx": xlsx,
            name_a: res_a["average"], name_b: res_b["average"],
            "n_images": len(common)}


def prepare_comparison_folders(src_dir, prefix, dest_name="for_comparison"):
    """Copy ``{prefix}*`` images into a clean subfolder, the prefix stripped
    from their names. Despite its name, the reference script COPIES
    (shutil.copy2, prepare_comparison_folders.py:33) and leaves the
    originals in place; so does this."""
    dest = os.path.join(src_dir, dest_name)
    os.makedirs(dest, exist_ok=True)
    copied = []
    for p in list_images(src_dir):
        base = os.path.basename(p)
        if base.startswith(prefix):
            tgt = os.path.join(dest, base[len(prefix):])
            shutil.copy2(p, tgt)
            copied.append(tgt)
    return copied
