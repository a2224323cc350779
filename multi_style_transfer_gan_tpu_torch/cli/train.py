"""CLI: enhanced CycleGAN training on CUDA (the flags of the JAX package's
``cli/train.py``).

  python -m multi_style_transfer_gan_tpu_torch.cli.train \\
      --data_root data/monet2photo --save_dir models --resume_dir runs/ckpt

  torchrun --nproc_per_node=N -m multi_style_transfer_gan_tpu_torch.cli.train \\
      --data_root data/monet2photo --batch_size 8

Reads ``{data_root}/trainA`` (Monet) and ``trainB`` (photos); writes the
reference's three ``.pth`` files every ``--checkpoint_every`` epochs, and the
full train state under ``--resume_dir``, from which a rerun resumes.

Under torchrun each of the N processes trains on ``cuda:LOCAL_RANK`` over
NCCL, on its slice of every global batch of ``--batch_size`` images (which
N must divide); the gradients are averaged over the ranks each phase, so
the run takes the steps one device would take on the global batch. Every
rank reads the same ``--pretrained`` and ``--resume_dir`` files and takes
rank 0's weights; only rank 0 writes checkpoints and metrics.
"""

import argparse
import os
import sys
import time

# The device the CLI trains on. It exits without CUDA; the CPU tests drive
# the same loop by replacing this (and the availability check).
DEVICE = "cuda"


def main(argv=None):
    p = argparse.ArgumentParser(
        description="enhanced CycleGAN training on CUDA: one card, or N "
                    "under torchrun --nproc_per_node=N, the global "
                    "--batch_size split among them")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--save_dir", type=str, default="models")
    p.add_argument("--pretrained", type=str, default=None,
                   help="warm-start both generators non-strictly from this "
                        "generator checkpoint")
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8,
                   help="the global batch; under torchrun a multiple of the "
                        "process count")
    p.add_argument("--channels", type=int, default=16,
                   help="generator width, any multiple of 4 (the generator "
                        "needs one); the card trains every such width, as far "
                        "as its memory holds the model")
    p.add_argument("--num_transformer_blocks", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint_every", type=int, default=20)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 compute with fp32 parameters and Adam (the "
                        "default)")
    p.add_argument("--fp32", action="store_true",
                   help="full fp32 compute (overrides the bf16 default)")
    p.add_argument("--fast_attention", action="store_true", default=True,
                   help="the hand-written training kernels (the default), "
                        "with pair-batched G/D calls")
    p.add_argument("--no_fast_attention", action="store_true",
                   help="train through the plain PyTorch formulation of the "
                        "attention and the transformer block instead (the "
                        "JAX package's XLA path), without pair batching; no "
                        "kernel launches (overrides the fast-attention "
                        "default)")
    p.add_argument("--remat", action="store_true",
                   help="recompute generator stages and blocks in the "
                        "backward (torch.utils.checkpoint); off by default")
    p.add_argument("--lr_decay", action="store_true",
                   help="CycleGAN-paper LR schedule: constant for the first "
                        "half of training, linear to zero over the second")
    p.add_argument("--pool_size", type=int, default=0,
                   help="discriminator replay buffer per direction (50 in "
                        "the CycleGAN paper); 0 (default) scores the current "
                        "fakes only, as the reference does")
    p.add_argument("--metrics_log", type=str, default=None,
                   help="append one JSON line per logged step/epoch here")
    p.add_argument("--image_size", type=int, default=256,
                   help="training resolution, a multiple of 32 (the "
                        "reference fixes 256)")
    p.add_argument("--resume_dir", type=str, default=None,
                   help="full-state checkpoints (parameters, Adam moments, "
                        "schedules, spectral-norm buffers, pools, epoch) are "
                        "written here every --checkpoint_every epochs, and a "
                        "rerun resumes from the latest")
    args = p.parse_args(argv)

    if args.image_size % 32:
        # the 1/4-scale token grid must divide the transformer's window of 8
        print(f"error: --image_size must be a multiple of 32, got "
              f"{args.image_size}", file=sys.stderr)
        return 2
    if args.pretrained and not os.path.exists(args.pretrained):
        print(f"error: --pretrained {args.pretrained} does not exist",
              file=sys.stderr)
        return 1

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port trains on the GPU",
              file=sys.stderr)
        return 1

    from ..data import ImageFolderDataset, prefetch_to_device
    from ..ops import to_model_range
    from ..parallel import (
        broadcast_module_, init_data_parallel, is_writer, local_batch_size,
        rank, world_size,
    )
    from ..train import (
        cyclegan_init_state, cyclegan_train_step,
        latest_step, pool_init, restore_train_state, save_models,
        save_train_state,
    )
    from ..utils import MetricsLogger
    from ..weights import extract_state_dict, load_pth

    device = init_data_parallel(DEVICE)
    try:
        local_batch_size(args.batch_size, world_size())
    except ValueError as e:
        print(f"error: --batch_size: {e}", file=sys.stderr)
        return 2
    pre = None
    if args.pretrained:
        print(f"warm-starting generators from {args.pretrained}")
        pre = extract_state_dict(load_pth(args.pretrained))

    monet = ImageFolderDataset(args.data_root, "A", img_size=args.image_size,
                               host_size=args.image_size)
    photo = ImageFolderDataset(args.data_root, "B", img_size=args.image_size,
                               host_size=args.image_size)
    print(f"monet: {len(monet)}  photo: {len(photo)}")

    decay_steps = None
    if args.lr_decay:
        # steps per epoch from the smaller domain (zip truncates to it)
        spe = min(len(monet), len(photo)) // args.batch_size or 1
        decay_steps = args.num_epochs * spe
        print(f"lr_decay: constant to step {decay_steps // 2}, then linear "
              f"to 0 at {decay_steps}")
    state = cyclegan_init_state(args.seed, args.channels,
                                args.num_transformer_blocks,
                                pretrained_params=pre,
                                decay_steps=decay_steps, device=device)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    fast = args.fast_attention and not args.no_fast_attention
    pools = None
    if args.pool_size > 0:
        pools = ((pool_init(args.pool_size, args.image_size, dtype,
                            device=device),
                  pool_init(args.pool_size, args.image_size, dtype,
                            device=device)),
                 torch.Generator().manual_seed(args.seed + 1))
        print(f"image pool: {args.pool_size} per direction, on the device")

    start_epoch = 0
    if args.resume_dir:
        if latest_step(args.resume_dir) is not None:
            _, start_epoch = restore_train_state(args.resume_dir, None, state,
                                                 pools)
            print(f"resumed from {args.resume_dir} at epoch {start_epoch}")
        else:
            print(f"no checkpoints under {args.resume_dir}; starting fresh")
    for m in (state.G_AB, state.G_BA, state.D_A, state.D_B):
        broadcast_module_(m)
    if world_size() > 1:
        print(f"data parallel: rank {rank()} of {world_size()}, "
              f"{args.batch_size // world_size()} images of each global "
              f"batch of {args.batch_size}")

    metrics = MetricsLogger(args.metrics_log if is_writer() else None)
    try:
        for epoch in range(start_epoch, args.num_epochs):
            t0 = time.time()
            it_a = monet.batches(args.batch_size, seed=args.seed + epoch,
                                 epochs=1, process_index=rank(),
                                 process_count=world_size())
            it_b = photo.batches(args.batch_size, seed=args.seed * 7 + epoch,
                                 epochs=1, process_index=rank(),
                                 process_count=world_size())
            steps = 0
            for i, (a, b) in enumerate(prefetch_to_device(zip(it_a, it_b),
                                                          device)):
                # uint8 crosses to the card; the model range is made there
                out = cyclegan_train_step(
                    state, to_model_range(a), to_model_range(b),
                    compute_dtype=dtype, remat=args.remat,
                    fast_attention=fast, pools=pools)
                state, losses = out[:2]
                if pools is not None:
                    pools = out[2]
                steps = i + 1
                if (i + 1) % args.log_every == 0:
                    vals = {k: float(v) for k, v in losses.items()}
                    msg = " ".join(f"{k}={v:.4f}" for k, v in vals.items())
                    print(f"epoch {epoch + 1} step {i + 1}: {msg}")
                    metrics.log(epoch=epoch + 1, step=i + 1, **vals)
            if (epoch + 1) % args.checkpoint_every == 0 and is_writer():
                save_models(state, args.save_dir, epoch + 1)
                if args.resume_dir:
                    save_train_state(state, args.resume_dir, epoch + 1, pools)
                print(f"checkpoints saved at epoch {epoch + 1}")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.time() - t0
            print(f"epoch {epoch + 1}/{args.num_epochs} done ({dt:.1f}s)")
            metrics.log(epoch=epoch + 1, epoch_seconds=dt,
                        img_pairs_per_sec=steps * args.batch_size
                        / max(dt, 1e-9))
    finally:
        metrics.close()
    return 0


if __name__ == "__main__":
    from ..parallel import close_data_parallel

    try:
        rc = main()
    finally:
        close_data_parallel()
    raise SystemExit(rc)
