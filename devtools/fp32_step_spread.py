"""How far fp32 evaluations of ``chip_smoke.py``'s fp32 training checks lie
from each other and from float64, and whether the checks see a planted
backward fault.

    PYTHONPATH=. python3 devtools/fp32_step_spread.py [--card] [--tensors] [--noise N] SPEC [SPEC ...]

Each SPEC is ``CHANNELS:SIZE:KIND:ADAM[:DRAW]``: KIND ``step`` is the CPU half of
the fp32 CycleGAN step check (``chip_smoke.fp32_step_card_vs_cpu``: one
step at ``CHANNELS``, ``SIZE``^2, batch 2, from the check's init on
``chip_smoke.fp32_step_host``'s images, its five losses), ``pretrain`` the
two fp32 enhanced pretrain steps (``chip_smoke.pretrain_losses``, on two
image batches and patch masks drawn from generators of the width's own);
ADAM ``warm`` starts from ``chip_smoke.warm_adam``'s Adams, as the checks
do, ``fresh`` from fresh ones, whose first update is lr times the
gradient's sign; DRAW, where given, seeds the images and masks in place
of SEED + CHANNELS (other draws of the same check). For each SPEC it
evaluates:

- on the CPU in fp32 on 4 intra-op threads and, without ``--card``, on 1
  (which changes nothing but the summation order);
- on the CPU in float64: the models' parameters, buffers and Adam state in
  float64 and every fp32 cast of the plain versions lifted; a dispatch
  hook counts the operations that still return fp32 or bf16, and the run
  fails unless there are none;
- under each of ``chip_smoke.PLANTED_FAULTS``: without ``--card`` on the
  CPU, with it on the card (from a warm Adam), where it also runs the
  clean fp32 evaluation twice;
- with ``--noise N``, on the CPU in float64 under ``Fp32Noise`` with seeds
  0 .. N-1: a rounding of fp32's size after every operation, whose spread
  is the result's conditioning;

and prints each evaluation's losses and the largest relative difference
of each from the float64 losses and from the CPU's fp32 losses, the
figure the checks hold at 1e-3. With ``--tensors`` it also prints the
gradient norms tensor by tensor (``chip_smoke.grad_terms``: each norm's
difference relative to the reference's norm, or to GRAD_NORM_FLOOR of
the largest): the TENSOR_ROWS tensors farthest from the CPU's fp32 norms
(the card's first evaluation with ``--card``, else the CPU on 1 thread),
each beside the CPU's fp32 and the reference's own distance from float64,
and names the farthest. The CPU evaluations run in two worker
processes of 4 threads beside the card's. At c256 a CPU evaluation takes
minutes (64^2: ~1 in fp32 on 4 threads, ~2 on 1).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import multiprocessing
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

CPU_THREADS = 4
TENSOR_ROWS = 6


def parse(spec):
    """(channels, size, kind, adam, draw): ``draw`` None without the
    optional fifth field."""
    channels, size, kind, adam, *draw = spec.split(":")
    if kind not in ("step", "pretrain") or adam not in ("warm", "fresh") \
            or len(draw) > 1:
        raise ValueError(f"bad spec {spec!r}")
    return (int(channels), int(size), kind, adam,
            int(draw[0]) if draw else None)


@contextlib.contextmanager
def lifted_fp32_casts():
    """Float64 tensors stay float64 through ``Tensor.float`` and the plain
    versions' default fp32 working type, and new tensors (Adam's step
    counts among them) are float64, for the span of the block: the port
    evaluated in float64 (``NarrowOps`` finds what still narrows)."""
    import importlib

    float_ = torch.Tensor.float
    kernels = "multi_style_transfer_gan_tpu_torch.ops.kernels."
    fns = (importlib.import_module(kernels + "window_attention_train")
           ._split_windows,
           *(getattr(importlib.import_module(kernels + "window_mhsa_train"), n)
             for n in ("_split_heads", "_qkv_heads")))
    defaults = [fn.__defaults__ for fn in fns]
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = (lambda self, *a, **k: self
                          if self.dtype == torch.float64
                          else float_(self, *a, **k))
    for fn in fns:
        fn.__defaults__ = tuple(torch.float64 if d is torch.float32 else d
                                for d in fn.__defaults__)
    try:
        yield
    finally:
        torch.set_default_dtype(dtype)
        torch.Tensor.float = float_
        for fn, d in zip(fns, defaults):
            fn.__defaults__ = d


class NarrowOps(TorchDispatchMode):
    """Counts (``count``) the operations run inside it whose outputs are
    fp32 or bf16: none, where a float64 evaluation is float64 throughout."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(o, torch.Tensor)
                    and o.dtype in (torch.float32, torch.bfloat16)):
                self.count += 1
        return out


class Fp32Noise(TorchDispatchMode):
    """Every float64 operation run inside it has its result scaled by
    1 + u, u uniform in +-2^-24 (fp32's unit roundoff) from a generator
    seeded ``seed``: a float64 evaluation with a rounding of fp32's size
    after each operation and none inside it, whose spread over seeds is
    how far fp32-sized roundings alone move a result (its conditioning).
    Results that share storage with an input (views, in-place updates) are
    left as they are."""

    def __init__(self, seed):
        super().__init__()
        self.gen = torch.Generator().manual_seed(seed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr()
                  for t in torch.utils._pytree.tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(o, torch.Tensor) and o.dtype == torch.float64
                    and o.numel() and o.device.type == "cpu"
                    and o.untyped_storage().data_ptr() not in inputs):
                u = torch.rand(o.shape, generator=self.gen,
                               dtype=torch.float64)
                o.mul_(1 + (2 * u - 1) * 2.0 ** -24)
        return out


def losses(spec, dtype_name, threads, device="cpu", fault=None,
           noise=None):
    """The losses of ``spec`` evaluated in ``dtype_name`` ("float32" or
    "float64", the latter on the CPU only) on ``device``, under the planted
    fault ``fault`` (or none), in float64 under ``Fp32Noise(noise)`` where
    ``noise`` is a seed: (losses, the gradient norms of
    ``chip_smoke.grad_norms``, operations that returned fp32 or bf16 in a
    float64 run)."""
    import numpy as np
    import chip_smoke as smoke
    from multi_style_transfer_gan_tpu_torch.data import random_patch_mask
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import (
        cyclegan_init_state, cyclegan_train_step, pretrain_init_state,
        pretrain_train_step,
    )

    channels, size, kind, adam, draw = parse(spec)
    if device == "cpu":
        torch.set_num_threads(threads)
    else:   # as chip_smoke.py runs the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    f64 = dtype == torch.float64

    def image(a):
        t = torch.from_numpy(a).to(device)
        return to_model_range(t.to(dtype) / 255.0 if f64 else t)

    seed = smoke.SEED + channels if draw is None else draw
    rng = np.random.default_rng(seed)   # as chip_smoke.fp32_step_host
    host = [np.stack(smoke.smooth_images(rng, 2, (size, size)))
            for _ in range(2)]
    gen = torch.Generator().manual_seed(seed)
    masks = [random_patch_mask(2, size, generator=gen, device="cpu")
             for _ in host]
    fault_ctx = (smoke.planted_fault(fault) if fault
                 else contextlib.nullcontext())
    lifted = lifted_fp32_casts() if f64 else contextlib.nullcontext()
    hook = NarrowOps() if f64 else contextlib.nullcontext()
    jitter = (Fp32Noise(noise) if noise is not None
              else contextlib.nullcontext())
    if kind == "step":
        st = cyclegan_init_state(smoke.SEED + 1, channels, 1, device=device)
        models, opts = (st.G_AB, st.G_BA, st.D_A, st.D_B), (st.g_opt,
                                                              st.d_opt)
    else:
        st = pretrain_init_state(smoke.SEED + 1, channels, model="enhanced",
                                 device=device)
        models, opts = (st.model,), (st.opt,)
    if f64:
        for m in models:
            m.double()
    with lifted:
        if adam == "warm":
            for opt in opts:
                smoke.warm_adam(opt)
        with fault_ctx, hook, jitter:
            if kind == "step":
                out = cyclegan_train_step(st, *(image(a) for a in host),
                                          compute_dtype=dtype)[1]
                out = {k: float(v) for k, v in out.items()}
                norms = smoke.grad_norms(st.G_AB, st.G_BA)
            else:
                out, norms = {}, None
                for i, (x, m) in enumerate(zip(host, masks)):
                    out[f"step {i + 1}"] = float(pretrain_train_step(
                        st, image(x), m.to(device, dtype),
                        compute_dtype=dtype)[1])
                    norms = norms or smoke.grad_norms(st.model)
    return ({k: float(np.float64(v)) for k, v in out.items()}, norms,
            hook.count if f64 else 0)


def tensor_names(spec):
    """The names of the gradient norms' tensors that ``losses`` returns
    for ``spec``, in order."""
    import chip_smoke as smoke
    from multi_style_transfer_gan_tpu_torch.train import (
        cyclegan_init_state, pretrain_init_state,
    )

    channels, _, kind, _, _ = parse(spec)
    if kind == "step":
        st = cyclegan_init_state(smoke.SEED + 1, channels, 1, device="cpu")
        return [f"{g}.{n}" for g, m in (("G_AB", st.G_AB), ("G_BA", st.G_BA))
                for n, _ in m.named_parameters()]
    st = pretrain_init_state(smoke.SEED + 1, channels, model="enhanced",
                             device="cpu")
    return [n for n, _ in st.model.named_parameters()]


def _worker_init():
    import os
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")


def rel(a, b):
    return max(abs(a[k] - b[k]) / abs(b[k]) for k in b)


def print_tensors(probe, cpu32, ref, names, noisy=()):
    """The TENSOR_ROWS gradient tensors whose norms in ``probe`` (a row:
    (name, (losses, norms, ...))) lie farthest from the CPU's fp32 norms
    ``cpu32``, each beside how far ``cpu32``, ``probe`` and the largest of
    the ``noisy`` norms (the float64 evaluations under ``Fp32Noise``) lie
    from the float64 norms ``ref``; then the farthest tensor's name."""
    import chip_smoke as smoke

    label, (_, norms, *_) = probe
    vs_cpu = smoke.grad_terms(norms, cpu32)
    cpu_f64, probe_f64 = (smoke.grad_terms(n, ref) for n in (cpu32, norms))
    noise = [max(t) for t in zip(*(smoke.grad_terms(n, ref)
                                   for n in noisy))] or None
    order = sorted(range(len(names)), key=lambda i: -vs_cpu[i])
    print(f"  gradient norms tensor by tensor, {label} against CPU fp32 "
          f"(chip_smoke.grad_terms; float64 norm, CPU fp32 from float64, "
          f"{label} from float64):")
    for i in order[:TENSOR_ROWS]:
        print(f"    {names[i]}: {vs_cpu[i]:.3e} (float64 norm {ref[i]:.6e}; "
              f"CPU fp32 {cpu_f64[i]:.3e}, {label} {probe_f64[i]:.3e}"
              + ("" if noise is None else
                 f", Fp32Noise up to {noise[i]:.3e}") + " from float64)")
    i = order[0]
    print(f"  farthest: {names[i]}, {label} vs CPU fp32 {vs_cpu[i]:.3e}; "
          f"CPU fp32 vs float64 {cpu_f64[i]:.3e}"
          + ("" if noise is None else
             f"; float64 under Fp32Noise up to {noise[i]:.3e}"))


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    card = "--card" in args
    tensors = "--tensors" in args
    noise = 0
    if "--noise" in args:
        i = args.index("--noise")
        noise = int(args[i + 1])
        args = args[:i] + args[i + 2:]
    specs = [a for a in args if a not in ("--card", "--tensors")]
    if not specs:
        print(__doc__, file=sys.stderr)
        return 2
    for spec in specs:
        parse(spec)
    import chip_smoke as smoke

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=ctx, initializer=_worker_init) as pool:
        cpu = {}
        for spec in specs:
            runs = [("float64", CPU_THREADS), ("float32", CPU_THREADS)]
            if not card:
                runs.append(("float32", 1))
            for dtype, threads in runs:
                cpu[spec, dtype, threads] = pool.submit(
                    losses, spec, dtype, threads)
            if not card:
                for fault in smoke.PLANTED_FAULTS:
                    cpu[spec, fault] = pool.submit(
                        losses, spec, "float32", CPU_THREADS, "cpu", fault)
            for seed in range(noise):
                cpu[spec, "noise", seed] = pool.submit(
                    losses, spec, "float64", CPU_THREADS, "cpu", None, seed)
        on_card = {}
        if card:
            for spec in specs:
                on_card[spec, "card fp32 (1)"] = losses(
                    spec, "float32", 0, "cuda")
                on_card[spec, "card fp32 (2)"] = losses(
                    spec, "float32", 0, "cuda")
                if parse(spec)[3] == "warm":
                    for fault in smoke.PLANTED_FAULTS:
                        on_card[spec, f"card fp32, {fault}"] = losses(
                            spec, "float32", 0, "cuda", fault)
        for spec in specs:
            ref, ref_norms, narrow = cpu[spec, "float64", CPU_THREADS].result()
            names = tensor_names(spec)
            if narrow:
                raise AssertionError(f"{spec}: the float64 run returned "
                                     f"{narrow} fp32 or bf16 tensors")
            cpu32 = cpu[spec, "float32", CPU_THREADS].result()
            rows = [("CPU fp32, 4 threads", cpu32)]
            if not card:
                rows.append(("CPU fp32, 1 thread",
                             cpu[spec, "float32", 1].result()))
                rows += [(f"CPU fp32, {fault}", cpu[spec, fault].result())
                         for fault in smoke.PLANTED_FAULTS]
            rows += [(name, out) for (s, name), out in on_card.items()
                     if s == spec]
            print(f"== {spec}\nCPU float64: {ref}")
            for name, (out, norms, *_) in rows:
                print(f"{name}: {out}\n    losses vs float64 "
                      f"{rel(out, ref):.3e}, vs CPU fp32 "
                      f"{rel(out, cpu32[0]):.3e}; gradient norms "
                      f"(chip_smoke.grad_rel) vs float64 "
                      f"{smoke.grad_rel(norms, ref_norms):.3e}, vs CPU fp32 "
                      f"{smoke.grad_rel(norms, cpu32[1]):.3e}")
            noisy = [cpu[spec, "noise", seed].result()[1]
                     for seed in range(noise)]
            for seed, norms in enumerate(noisy):
                terms = smoke.grad_terms(norms, ref_norms)
                far = max(range(len(terms)), key=terms.__getitem__)
                print(f"float64 under Fp32Noise({seed}): gradient norms "
                      f"vs float64 {terms[far]:.3e} ({names[far]})")
            if tensors:
                # the card's first evaluation, or the CPU on 1 thread
                print_tensors(rows[1], cpu32[1], ref_norms, names, noisy)
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
