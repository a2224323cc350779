"""CLI: micro-batching style-transfer HTTP server on the CUDA device.

  python -m multi_style_transfer_gan_tpu_torch.cli.serve --model models/G_BA_epoch_200.pth --bf16
  curl -s -X POST --data-binary @photo.jpg localhost:8000/stylize > monet.png
  curl -s localhost:8000/stats
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="style-transfer serving")
    p.add_argument("--model", type=str, required=True, nargs="+",
                   help="one or two checkpoints; with two, requests route "
                        "by ?direction= (labels from each checkpoint's "
                        "G_AB/G_BA key: AB=monet2photo, BA=photo2monet)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--canvas", type=int, default=256)
    p.add_argument("--max_batch", type=int, default=8,
                   help="micro-batch size (one fixed batch shape)")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="batching window after the first request")
    p.add_argument("--mode", choices=["cyclegan", "local_style"],
                   default="cyclegan")
    p.add_argument("--local_style_mode",
                   choices=["simple", "enhanced", "advanced"],
                   default="enhanced")
    p.add_argument("--strength", type=float, default=0.8)
    p.add_argument("--detail", type=float, default=0.7)
    p.add_argument("--enhance_colors", action="store_true", default=True)
    p.add_argument("--no_enhance_colors", dest="enhance_colors",
                   action="store_false")
    p.add_argument("--smooth", action="store_true", default=True)
    p.add_argument("--no_smooth", dest="smooth", action="store_false")
    p.add_argument("--max_queue", type=int, default=None,
                   help="admission bound (default 4 batches; beyond it "
                        "requests get 503)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fast_attention", action="store_true",
                   help="accepted for script compatibility: on a CUDA "
                        "device the hand-written kernels always run")
    p.add_argument("--engine", choices=["nhwc", "packed", "int8"],
                   default="nhwc",
                   help="generator engine: nhwc, or packed (the "
                        "space-to-depth engine, same math, canvas a multiple "
                        "of 32), or int8 (the EXPERIMENTAL post-training-"
                        "quantized engine, calibrated on a seeded synthetic "
                        "batch; a plain checkpoint runs nhwc)")
    p.add_argument("--precision", choices=["default", "high", "highest"],
                   default="default")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..pipelines import load_generator
    from ..serving import StyleTransferService, serve

    dir_label = {"AB": "monet2photo", "BA": "photo2monet"}
    services = {}
    for i, path in enumerate(args.model):
        model = load_generator(path, precision=args.precision, device="cuda")
        print(f"loaded {model.kind} generator (channels={model.channels}, "
              f"direction={model.direction}) from {path}")
        name = dir_label.get(model.direction, f"model{i}")
        if name in services:  # two checkpoints with the same direction key
            name = f"{name}_{i}"
        services[name] = StyleTransferService(
            model, canvas=args.canvas, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, mode=args.mode,
            local_style_mode=args.local_style_mode, strength=args.strength,
            detail=args.detail, enhance_colors=args.enhance_colors,
            smooth=args.smooth,
            compute_dtype=torch.bfloat16 if args.bf16 else None,
            engine=args.engine, max_queue=args.max_queue, device="cuda")
    print(f"directions: {sorted(services)} "
          f"(default {next(iter(services))})")
    print("warming up (builds the kernels on first use)...")
    server = serve(services, args.host, args.port)
    print(f"serving on http://{server.server_address[0]}:"
          f"{server.server_address[1]}  (POST /stylize, GET /stats)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        for s in services.values():
            s.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
