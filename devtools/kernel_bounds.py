"""The least time the card could take for a kernel's work at the earlier
widths' shapes (``PERF.md`` section 6, "Earlier widths"), from
``chip_smoke.py``'s own work counts and ``bound``.

    PYTHONPATH=. python3 devtools/kernel_bounds.py

Each bound is the larger of the bytes the function must move (each input
read once, each output written once) over the card's memory rate and its
bf16 matrix-product flops over the tensor-core peak (``chip_smoke.bound``:
NVIDIA's published H100 SXM figures, HBM_BYTES_PER_S and
BF16_FLOPS_PER_S, at the full 700 W). The shapes are those the width
phases time, bf16, batch ``chip_smoke.TRAIN_BATCH`` at canvas 256:

- row 4, the fused block, on the (8, 64, 64, dim) bottleneck grid at dims
  272 and 512 (the pair kernel) and 1024 (the chain);
- row 12, the window-MHSA mid forward + backward, at c256's (8, 64, 64,
  3 x 1024) qkv grid;
- row 11, the channel-attention mid forward + backward, over one
  generator's calls at c4 and c32 (``chip_smoke.width_train_kernel_cases``;
  down1 and up1 share a shape and count twice).

Runs on the CPU: nothing here touches a device.
"""

from __future__ import annotations

import chip_smoke as smoke

BLOCK_DIMS = (272, 512, 1024)
MHSA_CHANNELS = (256,)
MID_CHANNELS = (4, 32)


def rows():
    """[(label, bound ms, what bounds it)]."""
    out = []
    B, hw = smoke.TRAIN_BATCH, 256 // 4
    for dim in BLOCK_DIMS:
        out.append((f"row 4 block dim {dim} {(B, hw, hw, dim)}",
                    *smoke.bound(*smoke.block_work((B, hw, hw, dim)))))
    for c in MHSA_CHANNELS:
        _, _, shape, heads = smoke.width_train_kernel_cases(c)[-1]
        out.append((f"row 12 mid fwd + bwd c{c} {shape}, {heads} heads",
                    *smoke.bound(*smoke.mhsa_work(shape, heads))))
    for c in MID_CHANNELS:
        shapes = [shape for name, stage, shape, _ in
                  smoke.width_train_kernel_cases(c) if name == "attention"
                  for _ in range(2 if stage == "down1/up1" else 1)]
        out.append((f"row 11 mid fwd + bwd c{c}, a generator's calls "
                    f"{shapes}", *smoke.bound(*smoke.train_mid_work(shapes))))
    return out


def main() -> int:
    for label, ms, by in rows():
        print(f"{label}: bound {ms:.4f} ms ({by})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
