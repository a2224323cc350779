"""Is the uint8 stylize program on the card the same function at every
batch size?

    PYTHONPATH=. python3 devtools/batch_invariance.py

Loads the trained c16 generator and runs the uint8 -> uint8 program
(``make_batch_fn``, ``cyclegan`` mode) on 16 seeded photo-like images at
canvas 256, whole and in chunks of 8, 4, 2 and 1, for each engine (NHWC,
packed) in bf16 and in fp32 with TF32 off. For each it prints the largest
difference in uint8 levels from the batch-16 run, the share of values that
differ and each image's largest difference; then the program run twice
at batch 16 (run-to-run), and the 16 images split over two replicas of the
program at batch 8 against one replica's two batches of 8 (what
``batch_process(devices=[...])`` must match). Prints the card's name and
power limit. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np

import chip_smoke as smoke

IMAGES = 16
CHUNKS = (8, 4, 2, 1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smoke.card_line())
    dev = torch.device("cuda")
    model = load_generator(smoke.TRAINED, device=dev)
    x = np.stack(smoke.smooth_images(np.random.default_rng(3), IMAGES,
                                     (256, 256)))
    for engine in ("nhwc", "packed"):
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
            fns = [make_batch_fn(model, "cyclegan", compute_dtype=dtype,
                                 engine=engine, device=dev) for _ in range(2)]

            def run(fn, n, lo=0, hi=IMAGES):
                return np.concatenate([fn(x[i:i + n]).cpu().numpy()
                                       for i in range(lo, hi, n)]).astype(int)

            whole = run(fns[0], IMAGES)
            for n in CHUNKS:
                d = np.abs(run(fns[0], n) - whole)
                per = [int(d[i].max()) for i in range(IMAGES)]
                print(f"{engine} {name} batch {n} vs {IMAGES}: max {d.max()}, "
                      f"share {(d > 0).mean():.2e}, per image {per}")
            again = np.abs(run(fns[0], IMAGES) - whole).max()
            half = IMAGES // 2
            two = np.concatenate([run(fns[0], half, 0, half),
                                  run(fns[1], half, half, IMAGES)])
            one = run(fns[0], half)
            print(f"{engine} {name}: batch {IMAGES} twice max {again}; two "
                  f"replicas at batch {half} vs one, max "
                  f"{np.abs(two - one).max()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
