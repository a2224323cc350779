"""How large a square image does one card take, unsharded and sharded?

    PYTHONPATH=. python3 devtools/spatial_fit.py

Loads the trained c16 generator (fp32, precision 'default') and runs its
unsharded forward on one random size^2 image at sizes doubling from 2048,
then bisects in steps of 256 between the last size that ran and the first
that did not: the largest square size whose unsharded forward fits on the
card. A size fails on PyTorch's out-of-memory error or on any other error,
whose first line it prints. At that size and at the first failing one it
then runs the height-sharded forward (``parallel.spatial``) over
``[the card] * shards`` for 2 and 4 shards, and prints each run's peak
memory above what was resident before it (on one card every shard stays
resident, so this is not the memory of a shard on its own card). Prints
the card's name and power limit. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import sys

import chip_smoke as smoke

START, STEP, LIMIT = 2048, 256, 32768
SHARDS = (2, 4)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from multi_style_transfer_gan_tpu_torch.parallel import spatial_apply
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    print(smoke.card_line(), flush=True)
    dev = torch.device("cuda")
    model = load_generator(smoke.TRAINED, device=dev)
    runs = {1: model.apply}
    runs.update({n: spatial_apply(model, devices=[dev] * n) for n in SHARDS})

    def peak_gib(size, shards=1):
        """The forward's peak above the resident in GiB, or the first line
        of its error."""
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            x = torch.rand(1, size, size, 3, device=dev) * 2 - 1
            y = runs[shards](x)
            del x, y
            torch.cuda.synchronize()
        except (torch.OutOfMemoryError, RuntimeError) as e:
            return str(e).splitlines()[0][:160]
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    def fits(size):
        got = peak_gib(size)
        print(f"unsharded {size}^2: "
              + (f"peak {got:.3f} GiB" if isinstance(got, float)
                 else f"failed: {got}"), flush=True)
        return isinstance(got, float)

    good, bad = None, START
    while bad <= LIMIT and fits(bad):
        good, bad = bad, 2 * bad
    if good is None:
        print(f"not even {START}^2 fits")
        return 0
    bad = min(bad, LIMIT + STEP)
    while bad - good > STEP:
        mid = (good + bad) // 2 // STEP * STEP
        if fits(mid):
            good = mid
        else:
            bad = mid
    print(f"largest unsharded square: {good}^2 (the next step, {bad}^2, "
          f"fails)", flush=True)
    for size in (good, bad):
        for n in SHARDS:
            got = peak_gib(size, n)
            print(f"{n} shards on the one card at {size}^2: "
                  + (f"peak {got:.3f} GiB" if isinstance(got, float)
                     else f"failed: {got}"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
