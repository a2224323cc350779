"""How far apart do the card's gradients of one training step lie, from
run to run and between two gloo ranks and one rank?

    PYTHONPATH=. python3 devtools/dp_gradient_spread.py

The inputs of ``chip_smoke.py``'s two-rank check (a c16 CycleGAN step with
pools and a plain c64 pretrain step, fp32, TF32 off, warm Adams, a global
batch of 4 at 128^2; ``chip_smoke.dp_steps``): one rank twice with cuDNN's
default algorithms, twice with its deterministic ones, and two gloo ranks
sharing the card (``chip_smoke.dp_gloo_rank``, deterministic) twice. For
each pair it prints the losses' largest relative gap, the gradients' (each
tensor's difference over its norm, at least ``GRAD_NORM_FLOOR`` of the
largest, with the three farthest tensors) and their norms' (``grad_rel``).
Prints the card's name and power limit. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import tempfile

import chip_smoke as smoke


def gaps(got, ref) -> str:
    keys = list(ref["grads"])
    top = max(ref["grads"][k].norm().item() for k in keys)
    rel = sorted(((got["grads"][k] - ref["grads"][k]).norm().item()
                  / max(ref["grads"][k].norm().item(),
                        smoke.GRAD_NORM_FLOOR * top), k) for k in keys)
    norms = smoke.grad_rel([got["grads"][k].norm().item() for k in keys],
                           [ref["grads"][k].norm().item() for k in keys])
    loss = max(abs(got["losses"][k] - v) / abs(v)
               for k, v in ref["losses"].items())
    return (f"losses {loss:.2e}, gradients {rel[-1][0]:.2e} ("
            + ", ".join(f"{k} {r:.1e}" for r, k in rel[-3:])
            + f"), norms {norms:.2e}")


def two_ranks(spec_path, out_dir, dev):
    ctx = multiprocessing.get_context("spawn")
    go = ctx.Event()
    go.set()
    port = smoke.free_port()
    procs = [ctx.Process(target=smoke.dp_gloo_rank,
                         args=(r, port, spec_path, out_dir, dev, go))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(smoke.DP_TIMEOUT)
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"gloo ranks exited {[p.exitcode for p in procs]}")
    import torch

    return torch.load(os.path.join(out_dir, "rank0.pt"),
                      weights_only=True)["steps"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smoke.card_line())
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as work:
        spec_path = os.path.join(work, "dp_spec.pt")
        smoke.write_dp_spec(spec_path)
        spec = torch.load(spec_path, weights_only=True)

        def one():
            return smoke.dp_steps(dev, spec, lambda x: x)

        runs = {"default": (one(), one())}
        torch.backends.cudnn.deterministic = True
        runs["deterministic"] = (one(), one())
        two = []
        for i in range(2):
            out = os.path.join(work, f"ranks{i}")
            os.makedirs(out)
            two.append(two_ranks(spec_path, out, "cuda"))
        for part in ("cyclegan", "pretrain"):
            for mode, (a, b) in runs.items():
                print(f"{part}: one rank vs one rank, {mode} cuDNN: "
                      f"{gaps(b[part], a[part])}")
            print(f"{part}: two ranks vs one rank (deterministic): "
                  f"{gaps(two[0][part], runs['deterministic'][0][part])}")
            print(f"{part}: two ranks vs two ranks (deterministic): "
                  f"{gaps(two[1][part], two[0][part])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
