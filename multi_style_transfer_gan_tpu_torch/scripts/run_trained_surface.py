"""Drive every user-facing surface of the port with a trained model on the
CUDA device (the flags of the JAX repo's ``scripts/run_trained_surface.py``).

After the train CLI has written checkpoints (c16, one transformer block,
256^2, on the synthetic unpaired domains of ``data/synthetic.py``) and
``select_checkpoints`` has picked a pair, this pushes those weights through
every surface the reference ships:

  1. checkpoint tooling   : convert_model -> pth_info -> re-import, with the
                            converted file's forward bit-equal to the
                            original's
  2. batch CLI            : cyclegan at both canvases (256/512), local_style
                            enhanced at both and advanced at 256, both
                            directions, bf16
  3. quality study        : complete_comparison (the reference's
                            detailed_metrics_comparison.xlsx shape) and
                            compare_image_quality against the ground-truth
                            folders the synthetic domains ship
  4. FID harness          : m_test, panels and test_results.txt
  5. GUI compare path     : pipelines.compare.compare_models (the compare
                            tab's worker)
  6. advanced 5-variant   : generate_with_different_settings and its grid
  7. local-style advanced : the segmentation-driven region-adaptive path
  8. serving              : the micro-batching HTTP server answering
                            concurrent requests; latency percentiles, img/s
                            and /stats

Prints one summary JSON at the end; artifacts land under --output_dir.

  python -m multi_style_transfer_gan_tpu_torch.scripts.run_trained_surface \\
      --models_dir runs/models --epoch 240 \\
      --data_root data/synth_monet2photo --output_dir runs/surface
"""

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

DEVICE = "cuda"   # tests run the script on the CPU by replacing this


def stage_models(models_dir, epoch, stage_dir):
    """Lay the trained checkpoints out in the reference's fixed-path layout
    (batch_process_images.py:66,91,107). The plain-CycleGAN slot gets a
    dual checkpoint carrying the SAME trained enhanced generators: the
    reference ships no trainer for its plain model, and the loaders sniff
    the architecture from the keys, so raw ``--mode cyclegan`` runs the
    trained enhanced weights without post-processing."""
    import torch

    from ..weights import load_pth

    os.makedirs(stage_dir, exist_ok=True)
    ab = os.path.join(models_dir, f"G_AB_epoch_{epoch}.pth")
    ba = os.path.join(models_dir, f"G_BA_epoch_{epoch}.pth")
    shutil.copy2(ab, os.path.join(stage_dir, "G_AB_epoch_200.pth"))
    shutil.copy2(ba, os.path.join(stage_dir, "G_BA_epoch_200.pth"))
    dual = {"epoch": epoch,
            "G_AB_state_dict": load_pth(ab)["G_AB_state_dict"],
            "G_BA_state_dict": load_pth(ba)["G_BA_state_dict"]}
    torch.save(dual, os.path.join(stage_dir, "cyclegan_epoch_200.pth"))
    return stage_dir


def convert_roundtrip(stage_dir, out_dir):
    """convert_model + pth_info + re-import == original, on ``DEVICE``
    (cuDNN in its deterministic algorithms, so that two forwards of the same
    weights are bit-equal)."""
    import torch

    from ..cli import convert_model, pth_info
    from ..pipelines import load_generator

    src = os.path.join(stage_dir, "G_BA_epoch_200.pth")
    conv = os.path.join(out_dir, "converted_G_BA.pth")
    convert_model.main(["--input", src, "--output", conv])
    pth_info.main([conv])
    m0 = load_generator(src, device=DEVICE)
    m1 = load_generator(conv, device=DEVICE)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (1, 256, 256, 3)).astype(np.float32)).to(DEVICE)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        a = m0.apply(x).cpu().numpy()
        b = m1.apply(x).cpu().numpy()
    delta = float(np.abs(a - b).max())
    assert delta == 0.0, f"convert_model changed the forward: {delta}"
    print(f"convert_model roundtrip: identical forward (max |d| {delta})")
    return {"max_delta": delta}


def run_batches(stage_dir, data_root, out_dir):
    """The six batch-CLI runs; each must write an output for every input."""
    from ..cli import batch_process_images as bpi
    from ..data import list_images

    testb = os.path.join(data_root, "testB")
    testa = os.path.join(data_root, "testA")
    runs = [
        # photo -> monet: raw + post-processed, both canvases
        dict(mode="cyclegan", direction="photo2monet", inp=testb, canvas=256),
        dict(mode="local_style", direction="photo2monet", inp=testb,
             canvas=256),
        dict(mode="local_style", direction="photo2monet", inp=testb,
             canvas=512),
        # the batch CLI's 'advanced' local-style chain (equalize,
        # guided filter)
        dict(mode="local_style", direction="photo2monet", inp=testb,
             canvas=256, ls_mode="advanced"),
        # monet -> photo: raw, both canvases (G_AB)
        dict(mode="cyclegan", direction="monet2photo", inp=testa, canvas=256),
        dict(mode="cyclegan", direction="monet2photo", inp=testa, canvas=512),
    ]
    stats = []
    for r in runs:
        sub = os.path.join(out_dir, f"batch_{r['canvas']}")
        ls_mode = r.get("ls_mode", "enhanced")
        t0 = time.time()
        argv = ["--input_dir", r["inp"], "--output_dir", sub,
                "--mode", r["mode"], "--direction", r["direction"],
                "--models_dir", stage_dir, "--bf16", "--fast_attention",
                "--canvas", str(r["canvas"]),
                "--local_style_mode", ls_mode]
        rc = bpi.main(argv)
        assert rc in (0, None), f"batch CLI failed: {argv}"
        folder = (f"cyclegan_{r['direction']}" if r["mode"] == "cyclegan"
                  else f"local_style_{ls_mode}_{r['direction']}")
        written = len(list_images(os.path.join(sub, folder)))
        assert written == len(list_images(r["inp"])), (
            f"batch CLI wrote {written} images: {argv}")
        stats.append({**{k: v for k, v in r.items() if k != "inp"},
                      "seconds": round(time.time() - t0, 1),
                      "written": written})
        print(f"batch done: {r} ({stats[-1]['seconds']}s)")
    return stats


def quality_study(data_root, out_dir):
    """The reference-shaped study and the ground-truth study."""
    from ..cli import compare_image_quality as ciq
    from ..metrics.evaluation import compare_folder_pair, complete_comparison

    b256 = os.path.join(out_dir, "batch_256")
    raw = os.path.join(b256, "cyclegan_photo2monet")
    post = os.path.join(b256, "local_style_enhanced_photo2monet")
    truth = os.path.join(data_root, "truth_monet_for_testB")
    originals = os.path.join(data_root, "testB")

    # (a) reference-shaped 3-folder study (detailed_metrics_comparison.xlsx)
    ref_shape = complete_comparison(
        originals, raw, post, name_a="cyclegan", name_b="localstyle",
        output_dir=os.path.join(out_dir, "study_reference_shape"),
        device=DEVICE)
    print(f"reference-shape study: verdict={ref_shape['verdict']}")

    # (b) ground-truth study: compare to the KNOWN target (monetize(testB))
    gt_dir = os.path.join(out_dir, "study_ground_truth")
    os.makedirs(gt_dir, exist_ok=True)
    ciq.main(["--base_dir", truth, "--compare_dirs", raw, post,
              "--output_prefix", "trained_vs_truth",
              "--output_dir", gt_dir])

    # headline numbers for the docs: raw output vs ground truth, and the
    # null baseline: how far the INPUT photo is from the truth
    gt_raw = compare_folder_pair(truth, raw, device=DEVICE)["average"]
    gt_post = compare_folder_pair(truth, post, device=DEVICE)["average"]
    gt_null = compare_folder_pair(truth, originals, device=DEVICE)["average"]
    out = {"reference_shape": {k: ref_shape[k] for k in
                               ("n_images", "verdict", "xlsx")},
           "vs_truth": {"raw": gt_raw, "localstyle": gt_post,
                        "identity_baseline": gt_null}}
    print("vs ground truth:", json.dumps(out["vs_truth"], indent=1,
                                         default=float))
    return out


def fid_harness(stage_dir, data_root, out_dir):
    from ..cli import m_test

    fid_dir = os.path.join(out_dir, "m_test")
    m_test.main(["--data_root", data_root,
                 "--g_ab", os.path.join(stage_dir, "G_AB_epoch_200.pth"),
                 "--g_ba", os.path.join(stage_dir, "G_BA_epoch_200.pth"),
                 "--output_dir", fid_dir, "--max_images", "54"])
    results = Path(fid_dir, "test_results.txt")
    txt = results.read_text() if results.exists() else "<missing>"
    print("m_test results:\n" + txt)
    return {"test_results": txt}


def gui_compare(stage_dir, data_root, out_dir):
    from ..pipelines import load_generator
    from ..pipelines.compare import compare_models

    enh = load_generator(os.path.join(stage_dir, "G_BA_epoch_200.pth"),
                         device=DEVICE)
    cyc = load_generator(os.path.join(stage_dir, "cyclegan_epoch_200.pth"),
                         prefer="G_BA_state_dict", device=DEVICE)
    img = sorted(Path(data_root, "testB").iterdir())[0]
    res = compare_models(enh, cyc, str(img),
                         os.path.join(out_dir, "gui_compare"))
    print(f"gui compare-tab worker: {res}")
    return {k: str(v) for k, v in res.items()}


def advanced_variants(stage_dir, data_root, out_dir):
    """The 5-variant advanced_transform surface (standard, contrast,
    multiscale, detail, local) and the comparison grid, from G_BA."""
    from ..cli import advanced_transform

    img = str(sorted(Path(data_root, "testB").iterdir())[0])
    adv_dir = os.path.join(out_dir, "advanced_variants")
    advanced_transform.main(["--image", img,
                             "--model",
                             os.path.join(stage_dir, "G_BA_epoch_200.pth"),
                             "--output_dir", adv_dir])
    made = sorted(os.path.basename(p) for p in Path(adv_dir).iterdir())
    assert len(made) >= 6, made  # 5 variants + comparison grid
    print(f"advanced variants: {made}")
    return {"files": made}


def local_style_advanced(stage_dir, data_root, out_dir):
    """The segmentation-driven region-adaptive path (felzenszwalb
    superpixels on the host, per-region blending), on G_BA."""
    from ..cli import enhanced_local_style

    img = str(sorted(Path(data_root, "testB").iterdir())[1])
    out = os.path.join(out_dir, "local_style_advanced",
                       "enhanced_local.png")
    enhanced_local_style.main(["--image", img,
                               "--model",
                               os.path.join(stage_dir, "G_BA_epoch_200.pth"),
                               "--output", out])
    assert os.path.exists(out)
    print(f"local-style advanced (segmentation): {out}")
    return {"output": out}


def serving_stage(stage_dir, data_root, out_dir, n_requests=24,
                  concurrency=8):
    """The micro-batching HTTP server answering real requests: started
    in-process on a free port, concurrent JPEG POSTs from the test split,
    latency percentiles, aggregate img/s and /stats, then shut down. The
    hand-written kernels run where the model's device is CUDA, their plain
    versions on the CPU."""
    import threading
    import urllib.request

    import torch

    from ..pipelines import load_generator
    from ..serving import StyleTransferService, serve

    model = load_generator(os.path.join(stage_dir, "G_BA_epoch_200.pth"),
                           device=DEVICE)
    service = StyleTransferService(model, canvas=256, max_batch=8,
                                   compute_dtype=torch.bfloat16,
                                   device=model.device)
    server = serve(service, port=0)  # warmup=True runs the batch shape once
    host, port = server.server_address
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    files = sorted(Path(data_root, "testB").iterdir())
    payloads = [files[i % len(files)].read_bytes() for i in range(n_requests)]
    latencies = []
    lock = threading.Lock()
    srv_dir = os.path.join(out_dir, "serving")
    os.makedirs(srv_dir, exist_ok=True)

    def fire(i):
        req = urllib.request.Request(f"http://{host}:{port}/stylize",
                                     data=payloads[i], method="POST")
        t0 = time.time()
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
            assert r.status == 200, r.status
        with lock:
            latencies.append(time.time() - t0)
        if i == 0:
            with open(os.path.join(srv_dir, "response_0.png"), "wb") as f:
                f.write(body)

    t0 = time.time()
    threads = []
    for i in range(n_requests):  # bounded client concurrency
        th = threading.Thread(target=fire, args=(i,))
        th.start()
        threads.append(th)
        while sum(th.is_alive() for th in threads) >= concurrency:
            time.sleep(0.005)
    for th in threads:
        th.join()
    wall = time.time() - t0

    with urllib.request.urlopen(f"http://{host}:{port}/stats",
                                timeout=30) as r:
        stats = json.loads(r.read())
    server.shutdown()
    server.server_close()
    service.close()

    lat = np.sort(latencies)
    res = {"n_requests": n_requests, "concurrency": concurrency,
           "replies": len(latencies),
           "img_s": round(n_requests / wall, 2),
           "latency_p50_s": round(float(lat[len(lat) // 2]), 3),
           "latency_p95_s": round(float(lat[int(len(lat) * 0.95)]), 3),
           "server_stats": stats}
    print("serving:", json.dumps(res, indent=1))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models_dir", required=True)
    ap.add_argument("--epoch", type=int, required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--skip", type=str, default="",
                    help="comma list: convert,batch,study,fid,gui,"
                         "advanced,localadv,serving")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1

    os.makedirs(args.output_dir, exist_ok=True)
    skip = set(args.skip.split(",")) if args.skip else set()
    stage_dir = stage_models(args.models_dir, args.epoch,
                             os.path.join(args.output_dir, "models"))
    summary = {"epoch": args.epoch, "seconds": {}}
    stages = (
        ("convert", "convert", lambda: convert_roundtrip(
            stage_dir, args.output_dir)),
        ("batch", "batch", lambda: run_batches(
            stage_dir, args.data_root, args.output_dir)),
        ("study", "study", lambda: quality_study(
            args.data_root, args.output_dir)),
        ("fid", "fid", lambda: fid_harness(
            stage_dir, args.data_root, args.output_dir)),
        ("gui", "gui", lambda: gui_compare(
            stage_dir, args.data_root, args.output_dir)),
        ("advanced", "advanced_variants", lambda: advanced_variants(
            stage_dir, args.data_root, args.output_dir)),
        ("localadv", "local_style_advanced", lambda: local_style_advanced(
            stage_dir, args.data_root, args.output_dir)),
        ("serving", "serving", lambda: serving_stage(
            stage_dir, args.data_root, args.output_dir)),
    )
    for name, key, stage in stages:
        if name in skip:
            continue
        t0 = time.time()
        summary[key] = stage()
        summary["seconds"][name] = round(time.time() - t0, 2)
    path = os.path.join(args.output_dir, "surface_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1, default=float)
    print(f"\nsummary written: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
