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

    PYTHONPATH=. python3 devtools/batch_invariance.py --bisect

Bisects the bf16 program instead: for each engine and each cuDNN setting
of ``CUDNN_SETTINGS`` it runs the 16 images at batch 16 and in chunks of
4, recording each site's input and output (every module called through
``__call__``, by forward hooks, and every convolution, InstanceNorm,
linear and hand-written kernel the forward calls, ``SITES``), and
prints the first site in forward order whose output for the same image
is not bit-equal, with its largest difference, and every site whose input
is bit-equal while its output is not (a site that depends on the batch by
itself); then each hand-written kernel call of the forward replayed alone
on its recorded arguments, whole and in chunks of 1 and 4 (bit-equal
where the kernel is batch-invariant). Then ``chip_smoke.bf16_batch_sweep``
per canvas: the bf16 program's distance from the fp32 one (TF32 off) at
each batch of ``chip_smoke.BF16_GATE_BATCHES`` beside the gate it is held
to (the sweep stops at a batch past it).
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

import chip_smoke as smoke

IMAGES = 16
CHUNKS = (8, 4, 2, 1)
BISECT_CHUNK = 4
# (name, cudnn.benchmark, cudnn.deterministic)
CUDNN_SETTINGS = (("default", False, False), ("deterministic", False, True),
                  ("benchmark", True, False))
# the functions each engine's forward calls, wrapped by name in the module
# that calls them: the convolutions, InstanceNorms and linears and the
# hand-written kernels
SITES = {
    "nhwc": {"enhanced_generator": ("conv", "in_relu", "linear",
                                    "window_channel_attention"),
             "structural_transformer": ("conv", "linear",
                                        "fused_structural_block")},
    "packed": {"packed_generator": (
        "space_to_depth", "depth_to_space", "packed_conv2d",
        "packed_conv_transpose2d", "packed_instance_norm",
        "packed_per_channel_linear", "packed_global_avg_pool",
        "packed_window_channel_attention", "fused_structural_block")},
}

# the hand-written kernels among SITES, each with the count of its leading
# positional arguments that carry the batch: replayed alone on the whole
# batch's recorded arguments and on slices of them (``kernel_replays``)
KERNEL_BATCHED_ARGS = {"window_channel_attention": 1,
                       "packed_window_channel_attention": 1,
                       "fused_structural_block": 4, "space_to_depth": 1,
                       "depth_to_space": 1}
REPLAY_CHUNKS = (1, 4)


def first_tensor(v):
    """The first tensor in ``v`` (a tensor, or a tuple or list of them and
    other arguments), or None."""
    import torch

    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (tuple, list)):
        return next((t for t in map(first_tensor, v) if t is not None), None)
    return None


@contextlib.contextmanager
def recorded(fn, engine):
    """Every site of the program ``fn`` (``make_batch_fn``'s for ``engine``,
    its module as ``fn.module``) records (name, input, output) into the
    first list the block is given, in the order the sites finish: each
    module called through ``__call__`` (forward hooks) and each call of a
    function of SITES[engine], named after the innermost module running
    it. The second list gets each kernel call of KERNEL_BATCHED_ARGS as
    (site, kernel, function, args, kwargs)."""
    import importlib

    events, stack, calls = [], [], []

    def keep(name, inp, out):
        inp, out = first_tensor(inp), first_tensor(out)
        if out is not None:
            events.append((name, None if inp is None else inp.clone(),
                           out.clone()))

    def wrap(name, op):
        def call(*a, **kw):
            out = op(*a, **kw)
            site = f"{stack[-1] if stack else ''}/{name}"
            keep(site, a, out)
            if name in KERNEL_BATCHED_ARGS:
                calls.append((site, name, op, a, kw))
            return out
        return call

    saved = []
    for mod, names in SITES[engine].items():
        mod = importlib.import_module(
            f"multi_style_transfer_gan_tpu_torch.models.{mod}")
        for n in names:
            saved.append((mod, n, getattr(mod, n)))
            setattr(mod, n, wrap(n, getattr(mod, n)))
    def done(name, a, o):
        stack.pop()
        keep(name, a, o)

    hooks = []
    for name, m in fn.module.named_modules():
        name = name or "generator"
        hooks.append(m.register_forward_pre_hook(
            lambda m, a, name=name: stack.append(name)))
        hooks.append(m.register_forward_hook(
            lambda m, a, o, name=name: done(name, a, o)))
    try:
        yield events, calls
    finally:
        for h in hooks:
            h.remove()
        for mod, n, op in saved:
            setattr(mod, n, op)


def per_image(t, n):
    """``t`` as (n, ...) with its batch of n first, or None when its first
    axis is not a whole multiple of n (a weight, say)."""
    if t is None or t.dim() == 0 or t.shape[0] % n:
        return None
    return t.reshape(n, -1)


def max_diff(a, b):
    return (a.float() - b.float()).abs().max().item()


def bisect(fn, engine, x, dev):
    """The sites of ``fn`` on the images ``x`` (numpy uint8) at batch
    IMAGES against chunks of BISECT_CHUNK: (the first site whose output
    differs, as (index, name, largest difference), or None; the sites whose
    input is bit-equal and output is not, as (index, name, largest
    difference)); sites named by their place in forward order."""
    import torch

    with recorded(fn, engine) as (whole, _):
        fn(torch.from_numpy(x).to(dev))
    first, own = None, {}
    for lo in range(0, IMAGES, BISECT_CHUNK):
        with recorded(fn, engine) as (part, _):
            fn(torch.from_numpy(x[lo:lo + BISECT_CHUNK]).to(dev))
        if [e[0] for e in part] != [e[0] for e in whole]:
            raise AssertionError("the chunked forward ran other sites")
        for k, ((name, wi, wo), (_, pi, po)) in enumerate(zip(whole, part)):
            wo, po = per_image(wo, IMAGES), per_image(po, BISECT_CHUNK)
            if wo is None or po is None:
                continue
            d = max_diff(wo[lo:lo + BISECT_CHUNK], po)
            if d == 0:
                continue
            if first is None or k < first[0]:
                first = (k, name, d)
            wi, pi = per_image(wi, IMAGES), per_image(pi, BISECT_CHUNK)
            if wi is not None and pi is not None \
                    and torch.equal(wi[lo:lo + BISECT_CHUNK], pi):
                own[k] = (k, name, max(d, own.get(k, (0, 0, 0))[2]))
    # a module whose own output differs only through a site inside it is
    # not named: the innermost site is
    inner = lambda a, b: b.startswith(a + ".") or b.startswith(a + "/") \
        or (a == "generator" and b != a)
    own = sorted(own.values())
    return first, [o for o in own
                   if not any(inner(o[1], p[1]) for p in own if p is not o)]


def kernel_replays(fn, engine, x, dev):
    """Each hand-written kernel call of one forward of ``fn`` on ``x``,
    replayed alone on its recorded arguments: whole, and in slices of each
    of REPLAY_CHUNKS images (the batched arguments sliced, the rest as
    recorded). Returns [(site, kernel, chunk, max |d| from the whole
    call's output)]: 0 where the kernel is batch-invariant."""
    import torch

    with recorded(fn, engine) as (_, calls):
        fn(torch.from_numpy(x).to(dev))
    out = []
    for site, name, op, a, kw in calls:
        with torch.inference_mode():   # as the program calls them
            k = KERNEL_BATCHED_ARGS[name]
            whole = op(*a, **kw)
            for n in REPLAY_CHUNKS:
                parts = [op(*[t[i:i + n] for t in a[:k]], *a[k:], **kw)
                         for i in range(0, a[0].shape[0], n)]
                out.append((site, name, n,
                            max_diff(torch.cat(parts), whole)))
    return out


def main_bisect(torch, dev, model, x) -> int:
    from multi_style_transfer_gan_tpu_torch.pipelines import make_batch_fn

    cudnn = torch.backends.cudnn
    for engine in ("nhwc", "packed"):
        fn = make_batch_fn(model, "cyclegan", compute_dtype=torch.bfloat16,
                           engine=engine, device=dev)
        for setting, benchmark, deterministic in CUDNN_SETTINGS:
            saved = cudnn.benchmark, cudnn.deterministic
            cudnn.benchmark, cudnn.deterministic = benchmark, deterministic
            try:
                first, own = bisect(fn, engine, x, dev)
            finally:
                cudnn.benchmark, cudnn.deterministic = saved
            head = f"{engine} bf16, cuDNN {setting}, batch {IMAGES} vs " \
                   f"chunks of {BISECT_CHUNK}"
            if first is None:
                print(f"{head}: every site bit-equal")
                continue
            print(f"{head}: first site that differs #{first[0]} "
                  f"{first[1]}, max |d| {first[2]:.3e}; sites that differ "
                  f"on bit-equal input: "
                  + ", ".join(f"#{k} {n} ({d:.3e})" for k, n, d in own))
        replays = kernel_replays(fn, engine, x, dev)
        print(f"{engine} bf16: {len(replays)} kernel replays on the "
              f"recorded arguments in chunks of {REPLAY_CHUNKS}, largest "
              f"difference from the whole batch "
              f"{max(r[3] for r in replays):.3e}; "
              + ", ".join(sorted({f'{r[1]} {r[3]:.1e}' for r in replays
                                  if r[3] > 0})))
        fp32 = make_batch_fn(model, "cyclegan", engine=engine, device=dev)
        for canvas in smoke.CANVASES:
            try:
                smoke.bf16_batch_sweep(f"{engine} (cuDNN default)", fn,
                                       fp32, canvas,
                                       ("trained", engine, canvas), dev)
            except AssertionError as e:
                print(f"PAST THE GATE: {e}")
    return 0


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
    if "--bisect" in sys.argv[1:]:
        return main_bisect(torch, dev, model, x)
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
