"""multi_style_transfer_gan_tpu_torch — the PyTorch/CUDA port for NVIDIA Hopper.

The JAX package ``multi_style_transfer_gan_tpu`` beside this one is the
reference; this package mirrors its layout so each counterpart sits under
the same path:

- ``core``      — instance norm with fp32 statistics (and the fused IN +
                  activation with a hand-written backward), spectral norm,
                  zero-safe L2 normalize, exact-erf GELU, and convs and
                  Linears that cast their weights to the activation's type.
- ``ops``       — image-range helpers, the classical-CV toolbox, the GUI's
                  blend effects and the hand-written CUDA kernels
                  (``ops.kernels``), each beside its plain PyTorch version.
- ``models``    — the EnhancedGenerator, its StructuralTransformerBlock and
                  the EnhancedDiscriminator as ``nn.Module``s whose
                  ``state_dict()`` keys are exactly the reference
                  checkpoints' keys, initialized by the JAX package's laws.
- ``weights``   — ``.pth`` sniffing, conversion and inspection, and the
                  converters from JAX parameters.
- ``pipelines`` — checkpoint loader and the uint8->uint8 batch program with
                  its host pipeline.
- ``serving``   — the micro-batching HTTP server.
- ``train``     — the CycleGAN step, losses, image pool and checkpoints,
                  pretraining, and the VGG16 perceptual + Gram loss.
- ``data``      — image listing, the training folder dataset and prefetch.
- ``utils``     — the training metrics log.
- ``parallel``  — data parallelism: one process per GPU under torchrun
                  (NCCL; gloo on the CPU), the gradient all-reduces, and the
                  batch CLI's local device list (``--data_parallel``); and
                  height-sharded inference of one image over a list of
                  devices (``spatial``, ``direct_transform --spatial N``).
- ``gui``       — the desktop GUI: login, the four tabs and their model
                  manager.
- ``cli``       — every command-line entry point of the JAX package.

Nothing here imports ``jax``. Activations are logical NCHW tensors in
``torch.channels_last`` memory, so the kernels read (B, H, W, C) rows
without a copy. On a CPU tensor every kernel wrapper runs its plain version;
on a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"
