"""CLI: masked-inpainting pretraining on CUDA (the flags of the JAX
package's ``cli/pretrain.py``; the reference's pretrain.py and
pretrain_resume.py).

  python -m multi_style_transfer_gan_tpu_torch.cli.pretrain \\
      --data_root data/monet2photo --save_dir models

  torchrun --nproc_per_node=N \\
      -m multi_style_transfer_gan_tpu_torch.cli.pretrain --data_root ...

Trains the plain Generator (or, with ``--model enhanced``, the
EnhancedGenerator) on both domains of ``{data_root}/trainA`` and ``trainB``
with the random-patch mask, writes
``{save_dir}/generator_pretrain_epoch_N.pth`` every ``--checkpoint_every``
epochs, and ``--resume`` continues from such a file at its epoch + 1.

Under torchrun each of the N processes trains on ``cuda:LOCAL_RANK`` over
NCCL, on its slice of every global batch of ``--batch_size`` images (which
N must divide) and its block of the global batch's mask; the gradients are
averaged over the ranks before the clip and the plain model's BatchNorms
take the global batch's statistics, so the run takes the steps one device
would take on the global batch. Every rank resumes from the same file and
takes rank 0's weights; only rank 0 writes checkpoints and metrics.
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
        description="masked-inpainting pretraining on CUDA: one card, or N "
                    "under torchrun --nproc_per_node=N, the global "
                    "--batch_size split among them")
    p.add_argument("--data_root", type=str, required=True,
                   help="monet2photo root containing trainA/trainB")
    p.add_argument("--save_dir", type=str, default="models")
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=16,
                   help="the global batch; under torchrun a multiple of the "
                        "process count")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--model", choices=["plain", "enhanced"], default="plain",
                   help="plain = the reference recipe (Generator(64)); "
                        "enhanced = pretrain the EnhancedGenerator itself "
                        "so cli.train's --pretrained warm start actually "
                        "transfers (the reference's plain->enhanced "
                        "non-strict load shares zero keys); on the card it "
                        "trains --channels at any width")
    p.add_argument("--num_transformer_blocks", type=int, default=1,
                   help="enhanced model only")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint to resume from (pretrain_resume parity)")
    p.add_argument("--checkpoint_every", type=int, default=50)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--metrics_log", type=str, default=None,
                   help="append one JSON line per logged step/epoch here")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 compute — the default (the reference pretrain "
                        "runs torch autocast by default, pretrain.py:160; "
                        "bf16 needs no loss scaling)")
    p.add_argument("--fp32", action="store_true",
                   help="full fp32 compute (overrides the bf16 default)")
    args = p.parse_args(argv)

    if args.resume and not os.path.exists(args.resume):
        print(f"error: --resume {args.resume} does not exist", file=sys.stderr)
        return 1

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port trains on the GPU",
              file=sys.stderr)
        return 1

    from ..data import ImageFolderDataset
    from ..parallel import (
        broadcast_module_, init_data_parallel, is_writer, local_batch_size,
        world_size,
    )
    from ..train import pretrain_init_state, restore_pretrain_state
    from ..utils import MetricsLogger
    from ..weights import load_pth

    device = init_data_parallel(DEVICE)
    try:
        local_batch_size(args.batch_size, world_size())
    except ValueError as e:
        print(f"error: --batch_size: {e}", file=sys.stderr)
        return 2
    monet = ImageFolderDataset(args.data_root, "A", host_size=256)
    photo = ImageFolderDataset(args.data_root, "B", host_size=256)
    print(f"monet images: {len(monet)}  photo images: {len(photo)}")
    steps_per_epoch = ((len(monet) + len(photo)) // args.batch_size) or 1

    state = pretrain_init_state(
        args.seed, args.channels, num_epochs=args.num_epochs,
        steps_per_epoch=steps_per_epoch, lr=args.lr, model=args.model,
        num_transformer_blocks=args.num_transformer_blocks, device=device)
    start_epoch = 0
    if args.resume:
        # the step count (schedule, bias corrections) resumes at
        # start_epoch * steps_per_epoch, the Adam moments from the file
        start_epoch = restore_pretrain_state(state, load_pth(args.resume))
        print(f"resumed from {args.resume} at epoch {start_epoch}")
    broadcast_module_(state.model)

    if is_writer():
        os.makedirs(args.save_dir, exist_ok=True)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    # one generator in the same state on every rank: each draws the global
    # batch's mask and takes its block
    mask_gen = torch.Generator().manual_seed(args.seed + 1)
    metrics = MetricsLogger(args.metrics_log if is_writer() else None)
    try:
        _run_epochs(args, monet, photo, state, dtype, mask_gen, metrics,
                    start_epoch, device)
    finally:
        metrics.close()
    return 0


def _run_epochs(args, monet, photo, state, dtype, mask_gen, metrics,
                start_epoch, device):
    import torch

    from ..data import prefetch_to_device, random_patch_mask
    from ..ops import to_model_range
    from ..parallel import is_writer, rank, rank_block, world_size
    from ..train import pretrain_train_step, save_pretrain_checkpoint

    for epoch in range(start_epoch, args.num_epochs):
        t0 = time.time()
        epoch_total, epoch_count = 0.0, 0  # across BOTH domains
        for name, ds in (("monet", monet), ("photo", photo)):
            it = ds.batches(args.batch_size, seed=args.seed + epoch, epochs=1,
                            process_index=rank(), process_count=world_size())
            total, count = 0.0, 0
            for i, imgs in enumerate(prefetch_to_device(it, device)):
                # uint8 crosses to the card; the model range is made there
                _, H, W, _ = imgs.shape
                mask = rank_block(random_patch_mask(
                    args.batch_size, H, width=W, generator=mask_gen,
                    device=device))
                state, loss = pretrain_train_step(
                    state, to_model_range(imgs), mask, compute_dtype=dtype)
                total += float(loss)
                count += 1
                if (i + 1) % args.log_every == 0:
                    print(f"  epoch {epoch + 1} [{name}] step {i + 1}: "
                          f"loss {total / count:.4f}")
                    metrics.log(epoch=epoch + 1, domain=name, step=i + 1,
                                loss=total / count)
            epoch_total += total
            epoch_count += count
            if count:
                print(f"epoch {epoch + 1} [{name}]: mean loss "
                      f"{total / count:.4f}")
                metrics.log(epoch=epoch + 1, domain=name,
                            mean_loss=total / count)
        if (epoch + 1) % args.checkpoint_every == 0 and is_writer():
            path = os.path.join(args.save_dir,
                                f"generator_pretrain_epoch_{epoch + 1}.pth")
            save_pretrain_checkpoint(state, path, epoch,
                                     epoch_total / max(epoch_count, 1))
            print(f"checkpoint saved: {path}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"epoch {epoch + 1}/{args.num_epochs} done "
              f"({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    from ..parallel import close_data_parallel

    try:
        rc = main()
    finally:
        close_data_parallel()
    raise SystemExit(rc)
