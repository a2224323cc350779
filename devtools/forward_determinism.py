"""Is the fp32 generator forward on the card the same from run to run?

    PYTHONPATH=. python3 devtools/forward_determinism.py [input.npy]

Loads the trained c16 generator with ``precision="highest"`` (TF32 off) and
runs its forward ``RUNS`` times in one process on one input (a uint8 (N, H,
W, 3) array from ``input.npy``, else seeded photo-like images), in four
variants: as shipped; with the channel-attention kernel replaced by its
plain version on the card; with the fused block replaced by its plain
version; and as shipped under ``torch.backends.cudnn.deterministic = True``.
Then one forward with ``cudnn.benchmark`` on (cuDNN picks its fastest
algorithm per conv) and one with TF32 convolutions, each against the CPU.
For each variant it prints how many runs differ bit for bit from the first,
the largest difference between runs, the first module whose output differs
(forward hooks on every module), and each run's largest difference
from the CPU forward with the count of values beyond ``ATOL``; then the
fp32 CPU forward and the card's against the CPU forward in fp64. It also
prints the TF32 switches as the process finds them. Exits 1 without a CUDA
device. ``diagnose`` is what a test calls in its own process when its card
forward leaves the CPU's.
"""

from __future__ import annotations

import sys

import numpy as np

import chip_smoke as smoke

RUNS = 20
ATOL = 1e-3


def diagnose(model, cpu_model, x, ref, got) -> list:
    """What to know about a card forward ``got`` that left the CPU's ``ref``
    on input ``x`` (model range, on the CPU), as lines of text, taken in the
    process where it happened: whether a rerun repeats it; the CPU forward
    recomputed; either kernel replaced by its plain version on the card; and
    every module's largest |card - CPU| in forward order."""
    import torch

    from multi_style_transfer_gan_tpu_torch.models import (
        enhanced_generator, structural_transformer,
    )
    from multi_style_transfer_gan_tpu_torch.ops import kernels as K

    dev = next(model.module.parameters()).device
    xc = x.to(dev)
    far = lambda a, b: f"{(a - b).abs().max().item():.3e}"
    lines = []
    for i in range(3):
        again = model.apply(xc).cpu()
        lines.append(f"rerun {i}: max |card - cpu| {far(again, ref)}, max "
                     f"|rerun - first| {far(again, got)}")
    lines.append(f"cpu forward recomputed: max |d| to the first "
                 f"{far(cpu_model.apply(x), ref)}")
    swaps = ((enhanced_generator, "window_channel_attention",
              K.window_channel_attention_plain),
             (structural_transformer, "fused_structural_block",
              K.structural_block_plain))
    for module, name, plain in swaps:
        kernel = getattr(module, name)
        setattr(module, name, plain)
        try:
            lines.append(f"{name} plain on the card: max |card - cpu| "
                         f"{far(model.apply(xc).cpu(), ref)}")
        finally:
            setattr(module, name, kernel)
    outs, hooks = {}, []
    for tag, loaded in (("card", model), ("cpu", cpu_model)):
        for name, sub in loaded.module.named_modules():
            if name:
                hooks.append(sub.register_forward_hook(
                    lambda _m, _i, out, key=(tag, name): outs.update(
                        {key: out.detach().float().cpu()})
                    if torch.is_tensor(out) else None))
    model.apply(xc)
    cpu_model.apply(x)
    for h in hooks:
        h.remove()
    for name, _ in model.module.named_modules():
        if ("card", name) in outs and ("cpu", name) in outs:
            lines.append(f"module {name}: max |card - cpu| "
                         f"{far(outs[('card', name)], outs[('cpu', name)])}")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the determinism probe runs on the GPU",
              file=sys.stderr)
        return 1
    from multi_style_transfer_gan_tpu_torch.models import (
        enhanced_generator, structural_transformer,
    )
    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    print(smoke.card_line(), flush=True)
    print(f"[flags] cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"float32_matmul_precision {torch.get_float32_matmul_precision()}, "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark}, "
          f"cudnn.deterministic {torch.backends.cudnn.deterministic}")
    if argv:
        img = np.load(argv[0])
    else:
        img = np.stack(smoke.smooth_images(np.random.default_rng(smoke.SEED),
                                           2, (128, 128)))
    x = to_model_range(torch.from_numpy(img.astype(np.float32)) / 255.0)
    ref = load_generator(smoke.TRAINED, device="cpu").apply(x)
    model = load_generator(smoke.TRAINED, precision="highest", device="cuda")
    xc = x.cuda()

    leaves = [(n, m) for n, m in model.module.named_modules() if n]
    seen: dict = {}

    def hook(name):
        def fn(_module, _inputs, out):
            if torch.is_tensor(out):
                seen[name] = out.detach().clone()
        return fn

    for name, m in leaves:
        m.register_forward_hook(hook(name))

    def run_variant(label):
        first = first_seen = None
        differing, spread, first_module = 0, 0.0, None
        worst, beyond = [], []
        for _ in range(RUNS):
            seen.clear()
            got = model.apply(xc)
            torch.cuda.synchronize()
            d = (got.cpu() - ref).abs()
            worst.append(d.max().item())
            beyond.append(int((d > ATOL).sum()))
            if first is None:
                first, first_seen = got.clone(), dict(seen)
                continue
            if not torch.equal(got, first):
                differing += 1
                spread = max(spread, (got - first).abs().max().item())
                if first_module is None:
                    first_module = next(
                        (n for n, _ in leaves if n in seen and n in first_seen and
                         not torch.equal(seen[n], first_seen[n])), "none")
        print(f"[{label}] {differing}/{RUNS - 1} runs differ from the first "
              f"(max |d| between runs {spread:.3e}, first differing module "
              f"{first_module}); vs CPU max |d| min {min(worst):.3e} max "
              f"{max(worst):.3e}; values beyond {ATOL:g}: {sorted(set(beyond))} "
              f"of {ref.numel()}", flush=True)

    attention, block = (enhanced_generator.window_channel_attention,
                        structural_transformer.fused_structural_block)
    run_variant("kernels as shipped")
    enhanced_generator.window_channel_attention = K.window_channel_attention_plain
    run_variant("attention plain on the card")
    enhanced_generator.window_channel_attention = attention
    structural_transformer.fused_structural_block = K.structural_block_plain
    run_variant("block plain on the card")
    structural_transformer.fused_structural_block = block
    torch.backends.cudnn.deterministic = True
    run_variant("kernels as shipped, cudnn.deterministic")
    torch.backends.cudnn.deterministic = False
    # cuDNN free to take its fastest algorithm for every conv (Winograd,
    # FFT), still without TF32: how far can the choice of algorithm alone
    # move the forward?
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, benchmark=True, allow_tf32=False):
        for _ in range(3):
            got = model.module(xc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    d = (got.cpu() - ref).abs()
    print(f"[cudnn.benchmark, TF32 off] vs CPU max |d| {d.max().item():.3e}, "
          f"beyond {ATOL:g}: {int((d > ATOL).sum())}", flush=True)
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=True):
        got = model.module(xc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    d = (got.cpu() - ref).abs()
    where = torch.nonzero(d > ATOL)[:8].tolist()
    print(f"[TF32 convs] vs CPU max |d| {d.max().item():.3e}, beyond {ATOL:g}: "
          f"{int((d > ATOL).sum())} at (n, h, w, c) {where}", flush=True)
    # the CPU forward in fp64 (the plain attention and block stay fp32 inside)
    # as the yardstick of the fp32 CPU forward's own error
    ref64 = load_generator(smoke.TRAINED, device="cpu")
    ref64.module.double()
    r64 = ref64.apply(x.double()).float()
    d = (ref - r64).abs()
    print(f"[cpu fp32 vs cpu fp64] max |d| {d.max().item():.3e}, beyond "
          f"{ATOL:g}: {int((d > ATOL).sum())}")
    got = model.apply(xc).cpu()
    d = (got - r64).abs()
    print(f"[card fp32 vs cpu fp64] max |d| {d.max().item():.3e}, beyond "
          f"{ATOL:g}: {int((d > ATOL).sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
