"""A/B of the channel-attention kernel against an earlier copy of its source,
on the card.

    git archive <commit> multi_style_transfer_gan_tpu_torch/csrc | tar -x -C _dev/old
    PYTHONPATH=. python3 devtools/attention_ab.py \\
        _dev/old/multi_style_transfer_gan_tpu_torch/csrc

Builds ``window_channel_attention.cu`` from the given directory ("old") and
from this tree ("new") with the port's nvcc flags plus ``-Xptxas -v``, and
prints ptxas's registers, stack and spills of every kernel of both builds.
Then, swapping each build in under the port's wrappers, at the four
LocalAttention shapes of one c16 forward at canvas 256, batch 8
(``chip_smoke.attention_shapes``), on the NHWC and the packed-row entry
points: both builds must give bit-equal outputs in fp32 and bf16, and they
are timed in bf16 in turns (old, new, new, old; three rounds; CUDA events,
``chip_smoke.time_ms``). Raises on any build, launch, equality or ptxas
difference; exits 1 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import chip_smoke as smoke

SOURCE = "window_channel_attention.cu"
ROUNDS = 3


def build(csrc: str, out_dir: str, tag: str):
    """({entry: ctypes function}, {kernel: ptxas resource lines}) of
    ``csrc/SOURCE``."""
    from multi_style_transfer_gan_tpu_torch.ops.kernels import _build

    so = os.path.join(out_dir, f"{tag}.so")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc,
           "-o", so, os.path.join(csrc, SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    usage, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("Used" in line or "spill" in line):
            usage.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    lib = ctypes.CDLL(so)
    entries = {}
    for entry in ("window_channel_attention", "packed_window_channel_attention"):
        _, symbol, argtypes = _build.SIGNATURES[entry]
        fn = entries[entry] = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return entries, usage


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the kernel A/B runs on the GPU",
              file=sys.stderr)
        return 1
    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.ops.kernels import _build

    print(smoke.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        builds = dict(zip(("old", "new"), (
            build(os.path.abspath(argv[0]), tmp, "old"),
            build(_build.CSRC, tmp, "new"))))
    for tag, (_, usage) in builds.items():
        for name, lines in sorted(usage.items()):
            print(f"[ptxas {tag}] {name}: {'; '.join(lines)}")
    old_usage, new_usage = builds["old"][1], builds["new"][1]
    same = sorted(map(tuple, old_usage.values())) == sorted(
        map(tuple, new_usage.values()))
    print(f"[ptxas] {len(old_usage)} old and {len(new_usage)} new kernels; "
          f"same registers, stack and spills: {'yes' if same else 'NO'}",
          flush=True)

    def run(tag, wrapper, x, weights):
        """A no-argument call of ``wrapper`` through build ``tag``."""
        def call():
            _build._loaded[wrapper.__name__] = builds[tag][0][wrapper.__name__]
            return wrapper(x, *weights)
        return call

    shapes = [s for _, s in smoke.attention_shapes(256)]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    totals = {}
    for wrapper in (K.window_channel_attention,
                    K.packed_window_channel_attention):
        for shape in dict.fromkeys(shapes):
            B, H, W, C = shape
            for dtype in (torch.float32, torch.bfloat16):
                rand = lambda *s, scale=1.0: (torch.randn(
                    s, generator=gen, device="cuda") * scale).to(dtype)
                x = rand(*shape)
                if wrapper is K.packed_window_channel_attention:
                    x = x.reshape(B, H // 4, W // 4, 16 * C)
                weights = [rand(3 * C, C, scale=0.1), rand(3 * C),
                           rand(C, C, scale=0.1), rand(C)]
                old, new = (run(t, wrapper, x, weights) for t in ("old", "new"))
                if not torch.equal(old(), new()):
                    raise AssertionError(f"{wrapper.__name__} {shape} {dtype}: "
                                         f"old and new builds differ")
                if dtype == torch.float32:
                    continue
                turns = [smoke.time_turns(old, new) for _ in range(ROUNDS)]
                mean = [sum(t[i] for t in turns) / ROUNDS for i in (0, 1)]
                n = shapes.count(shape)
                for tag, ms in zip(("old", "new"), mean):
                    key = (wrapper.__name__, tag)
                    totals[key] = totals.get(key, 0.0) + n * ms
                print(f"[A/B] {wrapper.__name__} {shape} bf16: bit-equal (fp32 "
                      f"and bf16); old {mean[0]:.4f} ms, new {mean[1]:.4f} ms "
                      f"(new/old {mean[1] / mean[0]:.4f}); (old, new) per "
                      f"round {turns}", flush=True)
    for (name, tag), ms in sorted(totals.items()):
        print(f"[A/B] {name}, the four calls of a forward at canvas 256, "
              f"batch {smoke.BATCH}, bf16: {tag} {ms:.4f} ms", flush=True)
    if not same:
        raise AssertionError("the old and new builds use different registers, "
                             "stack or spills")
    return 0


if __name__ == "__main__":
    sys.exit(main())
