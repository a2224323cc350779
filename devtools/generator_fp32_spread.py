"""How far the port's fp32 forward of a seeded EnhancedGenerator lies from
float64, layer by layer, and (with ``--jax``) from the JAX package's.

    PYTHONPATH=. python3 devtools/generator_fp32_spread.py [CHANNELS] [--jax]

The generator and input of ``tests/test_torch_width_past128.py``'s
generator case (``EnhancedGenerator(CHANNELS, 1)`` seeded with CHANNELS, a
tanh'd normal image of 64^2 from ``default_rng(CHANNELS)``; CHANNELS 256 by
default), loaded through ``load_generator`` on the CPU. Prints the fp32
forward's max |d| from the port's own float64 forward (every fp32 cast of
the plain versions lifted, ``fp32_step_spread.NarrowOps`` finding none
left) on 1, 2, 4 and 8 intra-op threads; then each convolution's output
error, relative to its largest value, through the network, and the output
convolution's largest pre-activation. With ``--jax`` (the JAX package on
the CPU, a comparison only) also JAX's forward in fp32 and under
``jax.enable_x64`` from the same weights, and each forward's max |d| from
JAX's x64 one. About a minute at c256 on 8 cores.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from devtools.fp32_step_spread import NarrowOps, lifted_fp32_casts


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    use_jax = "--jax" in args
    rest = [a for a in args if a != "--jax"]
    channels = int(rest[0]) if rest else 256

    import multi_style_transfer_gan_tpu_torch.models.enhanced_generator as eg
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    module = eg.EnhancedGenerator(channels, 1, generator=torch.Generator()
                                  .manual_seed(channels))
    sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
    x = np.tanh(np.random.default_rng(channels).standard_normal(
        (1, 64, 64, 3))).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"enhanced_c{channels}.pth")
        torch.save({"G_AB_state_dict": sd}, path)
        model = load_generator(path, device="cpu")

    convs = []
    conv = eg.conv

    def traced(mod, h, *a, **k):
        out = conv(mod, h, *a, **k)
        convs.append(out.detach().double().clone())
        return out

    eg.conv = traced
    try:
        fp32 = {}
        for threads in (1, 2, 4, 8):
            torch.set_num_threads(threads)
            convs.clear()
            fp32[threads] = model.apply(torch.from_numpy(x)).double().numpy()
        convs32 = list(convs)
        convs.clear()
        model.module.double()
        x64 = torch.from_numpy(x).double()
        with lifted_fp32_casts(), NarrowOps() as narrow:
            f64 = model.apply(x64).numpy()
    finally:
        eg.conv = conv
    if narrow.count:
        raise AssertionError(f"the float64 forward returned {narrow.count} "
                             f"fp32 or bf16 tensors")
    print(f"c{channels} at 64^2, batch 1: the port's fp32 forward from its "
          f"float64 forward, max |d|: " + ", ".join(
              f"{t} threads {np.abs(y - f64).max():.3e}"
              for t, y in fp32.items()))
    for i, (a, b) in enumerate(zip(convs32, convs)):
        top = b.abs().max().item()
        print(f"  conv {i:2d} {tuple(b.shape[1:2])}: max |d| "
              f"{(a - b).abs().max().item():.3e}, relative to its largest "
              f"value {(a - b).abs().max().item() / top:.3e}")
    print(f"the output convolution's largest pre-activation "
          f"{convs[-1].abs().max().item():.2f}")

    if use_jax:
        import jax
        import jax.numpy as jnp

        from multi_style_transfer_gan_tpu.models.enhanced_generator import (
            enhanced_generator_apply,
        )
        from multi_style_transfer_gan_tpu.weights import (
            enhanced_generator_from_sd,
        )

        params = enhanced_generator_from_sd(
            {k: v.numpy().copy() for k, v in sd.items()})
        run = jax.jit(enhanced_generator_apply)
        j32 = np.asarray(jax.block_until_ready(run(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))))
        with jax.enable_x64(True):
            j64 = np.asarray(jax.block_until_ready(run(
                {k: jnp.asarray(np.asarray(v), jnp.float64)
                 for k, v in params.items()},
                jnp.asarray(x, jnp.float64))))
        print(f"from JAX's x64 forward, max |d|: the port's float64 "
              f"{np.abs(f64 - j64).max():.3e}, JAX's fp32 "
              f"{np.abs(j32 - j64).max():.3e}, the port's fp32 " + ", ".join(
                  f"{t} threads {np.abs(y - j64).max():.3e}"
                  for t, y in fp32.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
