"""Height-sharded inference over distinct cards: is it right, how fast is
it, and how much memory does each card hold?

    PYTHONPATH=. python3 devtools/spatial_cards.py

Needs two or more CUDA cards; shards over cuda:0 .. cuda:n-1 for n up to
the cards there are (2, 3 and 4 checked, 2 and 4 timed). With the trained c16 generator (fp32):

1. at 'highest' with deterministic cuDNN, the sharded forward against the
   unsharded one on cuda:0 at CHECKED (within 1 uint8 level on at most 1%
   of values), with 4 x n attention launches and one block launch a
   window-aligned piece (launches counted on every card);
2. at 'default', the unsharded forward and the sharded ones at each of
   TIMED sizes, in turns (unsharded, 2, .., n, n, .., 2, unsharded):
   host-clock ms a forward ending in a synchronize of every card, and the
   peak memory of each card above what it held before;
3. the largest square the sharded forward over every card takes, in steps
   of STEP from START (the largest the unsharded forward takes on one card,
   ``devtools/spatial_fit.py``), with each card's peak;
4. ``direct_transform --spatial 2`` against ``--spatial 0`` (within 1
   level), and ``--spatial`` one more than the cards (exit 1);
5. (run before 4) at BIG_UNSHARDED (the first that fits), 'highest', the
   unsharded forward on one card (up2's activations past 2^31 values) against the sharded one
   over every card (each shard a quarter of that): uint8 levels printed.

Prints the cards' names and power limits. Exits 1 with fewer than two
cards.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import tempfile
import time

import numpy as np

import chip_smoke as smoke

CHECKED = ((1024, 2), (1008, 3), (1024, 4), (960, 4))
TIMED = (2048, 4096, 8192)
ITERS = 3
START, STEP, LIMIT = 13056, 1024, 32768
BIG_UNSHARDED = (13056, 12288)   # the second where 'highest' needs more


def main() -> int:
    import torch

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print(f"error: needs two or more CUDA cards, have {n_cards}",
              file=sys.stderr)
        return 1
    import subprocess

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    smoke.phase_build()()
    return run([torch.device("cuda", i) for i in range(n_cards)])


def run(cards) -> int:
    """The four parts over the devices ``cards`` (built sources)."""
    import torch

    from multi_style_transfer_gan_tpu_torch.cli import direct_transform
    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.parallel import spatial
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    n_cards = len(cards)
    shard_counts = [n for n in (2, 4) if n <= n_cards]   # 16 n divides TIMED
    rng = np.random.default_rng(smoke.SEED + 22)

    def image(size):
        u = np.array(smoke.smooth_images(rng, 1, (size, size))[0], np.float32)
        return torch.from_numpy(u).to(cards[0])[None] / 127.5 - 1

    def u8(y):
        return torch.clamp(torch.round((y.float() + 1) * 127.5), 0, 255) \
            .to(torch.uint8).cpu().numpy()

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    # 1. right on distinct cards
    cudnn = torch.backends.cudnn
    cudnn.deterministic = True
    model = load_generator(smoke.TRAINED, precision="highest",
                           device=cards[0])
    for size, n in CHECKED:
        if n > n_cards:
            continue
        x = image(size)
        ref = model.apply(x)
        K.reset_launch_counts()
        got = spatial.gather_rows(
            spatial.spatial_apply(model, devices=cards[:n])(x), cards[0])
        launched = (K.window_channel_attention.launches,
                    K.fused_structural_block.launches)
        pieces = len(smoke.spatial_shapes(size, n)[1])
        dmax, share = smoke.u8_diff(u8(got), u8(ref))
        dfloat = (got - ref).abs().max().item()
        print(f"{size}^2 over {n} cards, highest: float max|d| {dfloat:.3e}, "
              f"uint8 max {dmax}, differing share {share:.3e}; launches "
              f"{launched}, expected {(4 * n, pieces)}", flush=True)
        if dmax > smoke.U8_MAX_DIFF or share > smoke.U8_MAX_SHARE \
                or launched != (4 * n, pieces):
            raise AssertionError(f"{size}^2 over {n} cards disagrees")
    cudnn.deterministic = False

    # 2. time and memory a card
    model = load_generator(smoke.TRAINED, device=cards[0])
    runs = {1: model.apply}
    runs.update({n: spatial.spatial_apply(model, devices=cards[:n])
                 for n in shard_counts})

    def peaks(fn):
        """Each card's peak GiB above its resident during ``fn()``, or
        the first line of the error."""
        torch.cuda.empty_cache()
        sync()
        base = [torch.cuda.memory_allocated(d) for d in cards]
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        try:
            fn()
            sync()
        except (torch.OutOfMemoryError, RuntimeError) as e:
            return str(e).splitlines()[0][:160]
        return [(torch.cuda.max_memory_allocated(d) - b) / 2**30
                for d, b in zip(cards, base)]

    for size in TIMED:
        x = image(size)

        def wall(fn):
            fn(x)
            sync()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                fn(x)
            sync()
            return (time.perf_counter() - t0) / ITERS * 1e3

        order = list(runs) + list(runs)[::-1]
        got = [wall(runs[n]) for n in order]
        ms = {n: (got[i] + got[-1 - i]) / 2 for i, n in enumerate(runs)}
        for n, f in runs.items():
            p = peaks(lambda f=f: f(x))
            print(f"{size}^2 {'unsharded' if n == 1 else f'over {n} cards'}: "
                  f"{ms[n]:.2f} ms ({ms[1] / ms[n]:.2f}x unsharded); peak "
                  + (", ".join(f"{g:.3f}" for g in p) + " GiB a card"
                     if isinstance(p, list) else f"failed: {p}"), flush=True)
        del x

    # 3. the largest square over every card
    n = n_cards if n_cards in runs else max(shard_counts)
    good, size = None, START
    while size <= LIMIT:
        x = None

        def big(size=size):
            nonlocal x
            x = torch.rand(1, size, size, 3, device=cards[0]) * 2 - 1
            runs[n](x)

        p = peaks(big)
        del x
        print(f"{size}^2 over {n} cards: "
              + (", ".join(f"{g:.3f}" for g in p) + " GiB a card"
                 if isinstance(p, list) else f"failed: {p}"), flush=True)
        if not isinstance(p, list):
            break
        good, size = size, size + STEP
    print(f"largest square over {n} cards, in steps of {STEP}: {good}^2",
          flush=True)

    # 5. past 2^31 elements: at BIG_UNSHARDED (the largest square the
    # unsharded forward takes on one card) up2's activations hold 16 x S^2
    # values, past 2^31, where a shard over every card holds a quarter
    cudnn.deterministic = True
    model = load_generator(smoke.TRAINED, precision="highest",
                           device=cards[0])
    for size in BIG_UNSHARDED:
        torch.cuda.empty_cache()
        try:
            x = torch.rand(1, size, size, 3, device=cards[0],
                           generator=torch.Generator(cards[0]).manual_seed(0))
            x = x * 2 - 1
            ref = u8(model.apply(x))
            got = np.concatenate([u8(y) for y in spatial.spatial_apply(
                model, devices=cards)(x)], axis=1)
        except torch.OutOfMemoryError as e:
            x = ref = got = None
            print(f"{size}^2, highest: {str(e).splitlines()[0][:120]}",
                  flush=True)
            continue
        dmax, share = smoke.u8_diff(got, ref)
        print(f"{size}^2, highest: unsharded on one card against {n_cards} "
              f"shards: uint8 max {dmax}, differing share {share:.3e}",
              flush=True)
        break
    x = ref = got = model = None
    cudnn.deterministic = False

    # 4. the CLI
    with tempfile.TemporaryDirectory() as tmp:
        from PIL import Image

        photo = os.path.join(tmp, "photo.png")
        Image.fromarray(smoke.smooth_images(rng, 1, (400, 300))[0]).save(photo)
        outs = {}
        for n_sp in (0, 2, n_cards + 1):
            out = os.path.join(tmp, f"out_{n_sp}.png")
            err = io.StringIO()
            with contextlib.redirect_stderr(err), \
                    contextlib.redirect_stdout(io.StringIO()):
                rc = direct_transform.main([
                    "--image", photo, "--model", smoke.TRAINED, "--size",
                    "512", "--precision", "highest", "--spatial", str(n_sp),
                    "--output", out])
            outs[n_sp] = out
            print(f"direct_transform --spatial {n_sp}: exit {rc} "
                  f"{err.getvalue().strip()}", flush=True)
            if rc != (1 if n_sp > n_cards else 0):
                raise AssertionError(f"--spatial {n_sp} exited {rc}")
        with Image.open(outs[2]) as a, Image.open(outs[0]) as b:
            dmax, share = smoke.u8_diff(np.asarray(a.convert("RGB")),
                                        np.asarray(b.convert("RGB")))
        print(f"direct_transform --spatial 2 vs unsharded: max {dmax} "
              f"level(s), differing share {share:.3e}", flush=True)
        if dmax > smoke.U8_MAX_DIFF or share > smoke.U8_MAX_SHARE:
            raise AssertionError("--spatial 2 and unsharded disagree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
