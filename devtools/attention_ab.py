"""A/B of the two serving kernels (the windowed channel attention and the
fused structural block) against an earlier copy of their sources, on the
card.

    git archive <commit> multi_style_transfer_gan_tpu_torch/csrc | tar -x -C _dev/old
    PYTHONPATH=. python3 devtools/attention_ab.py \\
        _dev/old/multi_style_transfer_gan_tpu_torch/csrc

Builds ``window_channel_attention.cu`` and ``fused_structural_block.cu``
(and the two training sources) from the given directory ("old") and from
this tree ("new") with the port's nvcc flags plus ``-Xptxas -v``, and prints
for every kernel of both builds ptxas's registers, stack and spills and the
number of HMMA (tensor-core) instructions in its SASS (``cuobjdump -sass``),
and the new kernels' shared memory per block. Then, swapping each build in
under the port's wrappers: the attention at the four LocalAttention shapes
of one c16 forward at canvas 256 and 512, batch 8
(``chip_smoke.attention_shapes``), on the NHWC and the packed-row entry
points, and the block at its shapes of the same forwards and a ragged grid,
in fp32 and bf16. Both builds must agree with the plain version inside
``chip_smoke.py``'s tolerances, and they are timed in turns (old, new, new,
old): CUDA events (``chip_smoke.time_ms``, three rounds) and profiler
device time (``chip_smoke.device_ms``). Then, bf16, each layout's own
width of the attention (``LAYOUT_SHAPES``) and of the block
(``BLOCK_DIM_SHAPES``), where a build that takes the widths in between
must give the old bits at the old speed, are timed the same way and
compared bit for bit; at ``SLOT_ODD_SHAPES`` the new build is held to the
plain version and the old one's distance is printed. The two training sources, which share headers with
them, are built from both directories too, and their forward and backward
must give the same bits at every train shape and, for the window-MHSA mid,
at 1, 2, 4 and 8 heads (the window-MHSA mid in bf16 only: its fp32 bodies
carry double since the head slots came, and are held to the plain version
at the fp32 tolerances, the old build's distance printed beside). Raises
on any build, launch or tolerance failure;
exits 1 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

import chip_smoke as smoke

SOURCES = {"window_channel_attention": ("window_channel_attention",
                                        "packed_window_channel_attention"),
           "fused_structural_block": ("fused_structural_block",),
           "fused_structural_block_pair": ("fused_structural_block_pair",),
           # not redesigned, but they share headers with the two above:
           # their old and new builds must give the same bits
           "window_attention_train": ("window_attention_train_fwd",
                                      "window_attention_train_bwd"),
           "window_mhsa_train": ("window_mhsa_train_fwd",
                                 "window_mhsa_train_bwd")}
ROUNDS = 3
BLOCK_SHAPES = ((smoke.BATCH, 64, 64, 64), (smoke.BATCH, 128, 128, 64),
                (2, 12, 20, 64))
# one shape per attention layout (CP = 16 .. 256) and per block design, at
# the generators' canvas-256 grids; C = 8 runs in the CP = 16 layout
B = smoke.BATCH
LAYOUT_SHAPES = ((B, 256, 256, 8), (B, 256, 256, 16), (B, 256, 256, 32),
                 (B, 128, 128, 64), (B, 64, 64, 128), (B, 64, 64, 256),
                 (B, 64, 64, 512))
# the pair kernel's (bf16 dims 260 .. 512) at c128's and c68's dims too
BLOCK_DIM_SHAPES = tuple((B, 64, 64, d) for d in (32, 64, 128, 256, 512,
                                                  272)) + (
    (2, 12, 20, 128), (2, 12, 20, 256),
    # the head-slot kernel: c12's dim 48 (an odd tile count a window, the
    # last tile unread) and c60's 240
    (B, 64, 64, 48), (B, 64, 64, 240))
# the head-slot kernel at dims whose windows have an odd tile count and read
# the last one (no generator's: c50, c55, c63), on more windows than blocks:
# the new build must meet the plain version, the old one's distance is
# printed (a build that picks the weight buffer by the tile's index within
# its window overwrites that last tile with the next window's first)
SLOT_ODD_SHAPES = tuple((B, 64, 64, d) for d in (200, 220, 252))


def demangle(text: str) -> str:
    try:
        return subprocess.run(["c++filt"], input=text, capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return text


def short(name: str) -> str:
    """A kernel's demangled name without namespaces and arguments."""
    name = name.split("(anonymous namespace)::")[-1]
    return re.sub(r"\(.*", "", name).replace("mstgan::", "")


def build(csrc: str, out_dir: str, tag: str):
    """({entry: ctypes function}, {kernel: [ptxas lines, HMMA count]}) of
    the sources in ``csrc``, all compiled at once."""
    from multi_style_transfer_gan_tpu_torch.ops.kernels import _build

    procs = {}
    for source in SOURCES:
        so = os.path.join(out_dir, f"{tag}-{source}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc,
               "-o", so, os.path.join(csrc, f"{source}.cu")]
        procs[source] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries, usage = {}, {}
    for source, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag} {source}:\n{out}")
        name = None
        for line in demangle(out).splitlines():
            m = re.search(r"Compiling entry function '(.+)' for", line)
            if m:
                name = short(m.group(1))
            elif name and ("Used" in line or "spill" in line):
                usage.setdefault(name, [[], 0])[0].append(
                    line.split(":", 1)[-1].strip())
        sass = subprocess.run(["cuobjdump", "-sass", so], capture_output=True,
                              text=True, check=True).stdout
        name = None
        for line in demangle(sass).splitlines():
            m = re.search(r"Function : (.+)", line)
            if m:
                name = short(m.group(1))
            elif name in usage and "HMMA" in line:
                usage[name][1] += 1
        lib = ctypes.CDLL(so)
        with open(os.path.join(csrc, f"{source}.cu")) as f:
            text = f.read()
        for entry in SOURCES[source]:
            _, symbol, argtypes = _build.SIGNATURES[entry]
            fn = entries[entry] = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            if (entry in ("fused_structural_block", "window_channel_attention",
                          "packed_window_channel_attention")
                    and "ws_windows" not in text):
                # a source from before the workspaces (the block's past dim
                # 256, the attention's past C = 512) takes no (ws,
                # ws_windows): called through an adapter that drops them
                fn.argtypes = argtypes[:12] + argtypes[14:]
                entries[entry] = (lambda f: lambda *a: f(*a[:12], *a[14:]))(fn)
    return entries, usage


def check(got, ref, dtype, tol, what):
    import torch

    err, ok = smoke.compare(got, ref, dtype)
    if dtype == torch.float32:
        ok = err <= tol
    if not (ok and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{what}: max|d| {err:.3e} outside tolerance")
    return err


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"old": build(os.path.abspath(argv[0]), tmp, "old"),
                  "new": build(_build.CSRC, tmp, "new")}
    for tag, (_, usage) in builds.items():
        for name, (lines, hmma) in sorted(usage.items()):
            print(f"[ptxas {tag}] {name}: {'; '.join(lines)}; HMMA in SASS "
                  f"{hmma}")

    from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
        block_launch_shape,
    )
    from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention import (
        attention_launch_shape,
    )
    for C in (8, 16, 32, 64, 128, 256):   # one width per built layout
        print(f"[smem new] attention C={C}: bf16 "
              f"{attention_launch_shape(1, C, True)[1]} B a block, fp32 "
              f"{attention_launch_shape(1, C, False)[1]} B")
    for C in (32, 64, 128, 256):
        print(f"[smem new] block bf16 C={C}: "
              f"{block_launch_shape(1, 8, 8, C)[1]} B a block", flush=True)

    def run(tag, wrapper, *args, **kw):
        """A no-argument call of ``wrapper`` through build ``tag`` (every
        entry point of the build swapped in: the block's dims past 256 run
        in the pair kernel's)."""
        def call():
            _build._loaded.update(builds[tag][0])
            return wrapper(*args, **kw)
        return call

    def ab(label, old, new, dtype):
        """Times old/new/new/old; returns (events old, new, device old, new)."""
        turns = [smoke.time_turns(old, new) for _ in range(ROUNDS)]
        ev = [sum(t[i] for t in turns) / ROUNDS for i in (0, 1)]
        dv = smoke.time_turns(old, new, timer=smoke.device_ms)
        print(f"[A/B] {label} {str(dtype)[6:]}: events old {ev[0]:.4f} -> new "
              f"{ev[1]:.4f} ms (x{ev[0] / ev[1]:.2f}); device old {dv[0]:.4f} "
              f"-> new {dv[1]:.4f} ms (x{dv[0] / dv[1]:.2f})", flush=True)
        return ev + dv

    def hold_train_bits(name, dtype, outs, label):
        """The old and new builds' outputs are the same bits; but the
        window-MHSA mid in fp32, whose sums the new build carries in double
        (as its plain version does; ``csrc/window_mhsa_train.cu``), is held
        to its plain version at the fp32 tolerances instead, and the old
        build's distance from it is printed beside."""
        ref = outs.pop("plain", None)
        if not (name == "mhsa" and dtype == torch.float32):
            if not all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"])):
                raise AssertionError(f"{label} {dtype}: old and new builds differ")
            return
        d = {tag: [(a.float() - r.float()).abs().max().item()
                   for a, r in zip(o, ref)] for tag, o in outs.items()}
        print(f"[A/B] {label} fp32: fwd / bwd max|d| from the plain version "
              f"(float64 inside): old {d['old'][0]:.3e} / {d['old'][1]:.3e}, new "
              f"{d['new'][0]:.3e} / {d['new'][1]:.3e}", flush=True)
        if d["new"][0] > smoke.FP32_TOL or d["new"][1] > smoke.TRAIN_GRAD_FP32_TOL:
            raise AssertionError(f"{label} fp32: the new build is outside the "
                                 f"fp32 tolerances")

    rng = np.random.default_rng(smoke.SEED)
    train = {"attention": (K.window_attention_mid_fwd,
                           K.window_attention_mid_bwd, (),
                           ("window_attention_train_fwd",
                            "window_attention_train_bwd")),
             "mhsa": (K.window_mhsa_fwd, K.window_mhsa_bwd, (2,),
                      ("window_mhsa_train_fwd", "window_mhsa_train_bwd"))}
    for name, stage, shape in smoke.train_kernel_cases():
        fwd, bwd, extra, entries = train[name]
        for label, host, g_host in smoke.train_kernel_inputs(rng, name, shape):
            for dtype in (torch.float32, torch.bfloat16):
                qkv = torch.from_numpy(host).to("cuda", dtype)
                d_out = torch.from_numpy(g_host).to("cuda", dtype)
                outs = {}
                for tag in ("old", "new"):
                    for entry in entries:
                        _build._loaded[entry] = builds[tag][0][entry]
                    outs[tag] = (fwd(qkv, *extra), bwd(qkv, d_out, *extra))
                if name == "mhsa":
                    outs["plain"] = (K.window_mhsa_plain(qkv, *extra),
                                     K.window_mhsa_backward_plain(qkv, d_out,
                                                                  *extra))
                hold_train_bits(name, dtype, outs, f"{name} train kernel {shape} {label}")
        print(f"[A/B] {name} train kernels {stage} {shape}: old and new builds "
              f"bit-equal, forward and backward, "
              f"{'bf16' if name == 'mhsa' else 'fp32 and bf16'}, on 3 inputs",
              flush=True)
    totals = {}
    for canvas in smoke.CANVASES:
        shapes = [s for _, s in smoke.attention_shapes(canvas)]
        for packed, wrapper, plain in (
                (False, K.window_channel_attention,
                 K.window_channel_attention_plain),
                (True, K.packed_window_channel_attention,
                 K.packed_window_channel_attention_plain)):
            for shape in dict.fromkeys(shapes):
                _, x, ws = smoke.attention_stress_inputs(rng, shape, packed)[0]
                for dtype in (torch.float32, torch.bfloat16):
                    args = [torch.from_numpy(np.asarray(a, np.float32))
                            .to("cuda", dtype) for a in [x] + ws]
                    old, new = (run(t, wrapper, *args) for t in ("old", "new"))
                    ref = plain(*args)
                    for tag, call in (("old", old), ("new", new)):
                        check(call(), ref, dtype, smoke.FP32_TOL,
                              f"{tag} {wrapper.__name__} {shape} {dtype}")
                    ms = ab(f"{wrapper.__name__} canvas {canvas} {shape}", old,
                            new, dtype)
                    key = (wrapper.__name__, canvas, dtype)
                    n = shapes.count(shape)
                    totals[key] = [a + n * b for a, b in zip(
                        totals.get(key, [0.0] * 4), ms)]
    for (name, canvas, dtype), ms in totals.items():
        print(f"[A/B] {name}, the four calls of a forward at canvas {canvas}, "
              f"batch {smoke.BATCH}, {str(dtype)[6:]}: events old {ms[0]:.4f} "
              f"-> new {ms[1]:.4f} ms; device old {ms[2]:.4f} -> new "
              f"{ms[3]:.4f} ms (x{ms[2] / ms[3]:.2f})", flush=True)

    for shape in BLOCK_SHAPES:
        _, host, weights = smoke.block_stress_inputs(rng, shape)[0]
        for dtype in (torch.float32, torch.bfloat16):
            t = lambda a, dt=dtype: torch.from_numpy(
                np.asarray(a, np.float32)).to("cuda", dt)
            args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                    t(host[3], torch.float32))
            kw = {n: t(a) for n, a in weights.items()}
            old, new = (run(tag, K.fused_structural_block, *args, **kw)
                        for tag in ("old", "new"))
            ref = K.structural_block_plain(*args, **kw)
            for tag, call in (("old", old), ("new", new)):
                check(call(), ref, dtype, smoke.BLOCK_FP32_TOL,
                      f"{tag} fused_structural_block {shape} {dtype}")
            ab(f"fused_structural_block {shape}", old, new, dtype)

    bf16 = torch.bfloat16
    for shape in LAYOUT_SHAPES:
        for packed, wrapper in ((False, K.window_channel_attention),
                                (True, K.packed_window_channel_attention)):
            _, x, ws = smoke.attention_stress_inputs(rng, shape, packed)[0]
            args = [torch.from_numpy(np.asarray(a, np.float32)).to("cuda", bf16)
                    for a in [x] + ws]
            old, new = (run(t, wrapper, *args) for t in ("old", "new"))
            same = torch.equal(old(), new())
            ab(f"{wrapper.__name__} {shape}, bit-equal {same}", old, new, bf16)
            if not same:
                raise AssertionError(f"{wrapper.__name__} {shape}: the builds "
                                     f"differ")
    for shape in BLOCK_DIM_SHAPES:
        _, host, weights = smoke.block_stress_inputs(rng, shape)[0]
        t = lambda a, dt=bf16: torch.from_numpy(
            np.asarray(a, np.float32)).to("cuda", dt)
        args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                t(host[3], torch.float32))
        kw = {n: t(a) for n, a in weights.items()}
        old, new = (run(tag, K.fused_structural_block, *args, **kw)
                    for tag in ("old", "new"))
        same = torch.equal(old(), new())
        ab(f"fused_structural_block {shape}, bit-equal {same}", old, new, bf16)
        if not same:
            raise AssertionError(f"fused_structural_block {shape}: the builds "
                                 f"differ")
    for shape in SLOT_ODD_SHAPES:
        _, host, weights = smoke.block_stress_inputs(rng, shape)[0]
        t = lambda a, dt=bf16: torch.from_numpy(
            np.asarray(a, np.float32)).to("cuda", dt)
        args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                t(host[3], torch.float32))
        kw = {n: t(a) for n, a in weights.items()}
        old, new = (run(tag, K.fused_structural_block, *args, **kw)
                    for tag in ("old", "new"))
        ref = K.structural_block_plain(*args, **kw)
        err_old, ok_old = smoke.compare(old(), ref, bf16)
        err_new = check(new(), ref, bf16, None,
                        f"new fused_structural_block {shape}")
        print(f"[A/B] fused_structural_block {shape} bf16 on more windows "
              f"than blocks: max|d| from the plain version old {err_old:.3e} "
              f"(inside the bf16 tolerance: {ok_old}), new {err_new:.3e}",
              flush=True)
    fwd, bwd, _, entries = train["mhsa"]
    for heads in (1, 2, 4, 8):
        shape = (smoke.BATCH, 64, 64, 96 * heads)
        _, host, g_host = smoke.train_kernel_inputs(rng, "mhsa", shape)[1]
        for dtype in (torch.float32, bf16):
            qkv = torch.from_numpy(host).to("cuda", dtype)
            d_out = torch.from_numpy(g_host).to("cuda", dtype)
            outs = {}
            for tag in ("old", "new"):
                for entry in entries:
                    _build._loaded[entry] = builds[tag][0][entry]
                outs[tag] = (fwd(qkv, heads), bwd(qkv, d_out, heads))
            outs["plain"] = (K.window_mhsa_plain(qkv, heads),
                             K.window_mhsa_backward_plain(qkv, d_out, heads))
            hold_train_bits("mhsa", dtype, outs, f"window-MHSA mid at {heads} heads")
        print(f"[A/B] window-MHSA mid at {heads} heads {shape}: old and new "
              f"builds bit-equal, forward and backward, bf16", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
