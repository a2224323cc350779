"""One rank of the data-parallel tests (tests/test_torch_parallel_train.py).

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py SPEC OUT

Joins the gloo job through the port's ``init_data_parallel`` (the
environment above is the one torchrun gives each process), runs every case
of the ``torch.save``'d SPEC on this rank's block of each global batch, and
writes what it saw to ``OUT/rank{r}.pt``. A case may plant one of FAULTS
for its span, the negative controls of the tests. Imports torch and the
port only.
"""

import contextlib
import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from multi_style_transfer_gan_tpu_torch.core import norm  # noqa: E402
from multi_style_transfer_gan_tpu_torch.parallel import mesh  # noqa: E402
from multi_style_transfer_gan_tpu_torch.train import (  # noqa: E402
    cyclegan, pool, pretrain,
)
from multi_style_transfer_gan_tpu_torch.weights import load_pth  # noqa: E402

FAULTS = ("sum", "local_bn", "rank_pools")


@contextlib.contextmanager
def planted(fault):
    """``fault`` (one of FAULTS, or None) in place for the block: "sum" is
    an all-reduce that sums without dividing, "local_bn" BatchNorm on each
    rank's own statistics, "rank_pools" an image pool per rank fed its own
    fakes."""
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    @torch.no_grad()
    def summed(tensors):
        mesh._flat_collective_(list(tensors), dist.all_reduce)

    def local_bn(x, running_mean, running_var, weight, bias, momentum, eps):
        return F.batch_norm(x.float(), running_mean, running_var,
                            weight.float(), bias.float(), True, momentum,
                            eps).to(x.dtype)

    if fault == "sum":
        patch(mesh, "all_reduce_mean_", summed)
    elif fault == "local_bn":
        patch(norm, "_batch_norm_global", local_bn)
    elif fault == "rank_pools":
        patch(cyclegan, "pool_sample_global", pool.pool_sample)
    elif fault is not None:
        raise ValueError(f"no fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def pools_of(pools):
    (pa, pb), gen = pools
    return {"images": [pa.images.clone(), pb.images.clone()],
            "n": [pa.n, pb.n], "generator": gen.get_state()}


def grads_of(state):
    return {n: {k: p.grad.clone() for k, p in getattr(state, n)
                .named_parameters() if p.grad is not None}
            for n in ("G_AB", "G_BA", "D_A", "D_B")}


def run_cyclegan(case):
    """``len(case["a"])`` CycleGAN steps from case["state"] (pools of
    case["pool_size"] when it is not 0), each on this rank's block of the
    global batches a[i], b[i]. Returns each step's losses and gradients
    (as averaged over the ranks: the G phase's and the D phase's), and the
    state (a ``CycleGANState.state_dict``) and pools before each step and
    after the last."""
    st = cyclegan.cyclegan_init_state(0, case["channels"],
                                      decay_steps=case["decay_steps"],
                                      device="cpu")
    # a copy: Adam's load_state_dict keeps the given tensors and steps them
    st.load_state_dict(copy.deepcopy(case["state"]))
    pools = None
    if case["pool_size"]:
        size = case["a"][0].shape[1]
        pools = ((pool.pool_init(case["pool_size"], size, device="cpu"),
                  pool.pool_init(case["pool_size"], size, device="cpu")),
                 torch.Generator().manual_seed(case["pool_seed"]))
    losses, grads, states, pool_states = [], [], [], []
    for a, b in zip(case["a"], case["b"]):
        states.append(copy.deepcopy(st.state_dict()))
        pool_states.append(pools and pools_of(pools))
        out = cyclegan.cyclegan_train_step(
            st, mesh.rank_block(a), mesh.rank_block(b), pair_batching=False,
            pools=pools)
        losses.append({k: float(v) for k, v in out[1].items()})
        grads.append(grads_of(st))
    states.append(copy.deepcopy(st.state_dict()))
    pool_states.append(pools and pools_of(pools))
    return {"losses": losses, "grads": grads, "states": states,
            "pools": pool_states}


def run_pretrain(case):
    """Pretrain steps resumed from case["checkpoint"], each on this rank's
    block of the global images and masks."""
    st = pretrain.pretrain_init_state(
        0, case["channels"], model=case["model"],
        num_epochs=case["num_epochs"],
        steps_per_epoch=case["steps_per_epoch"], device="cpu")
    pretrain.restore_pretrain_state(st, load_pth(case["checkpoint"]))
    losses = []
    for x, m in zip(case["images"], case["masks"]):
        st, loss = pretrain.pretrain_train_step(st, mesh.rank_block(x),
                                                mesh.rank_block(m))
        losses.append(float(loss))
    return {"losses": losses,
            "model": {k: v.detach().clone()
                      for k, v in st.model.state_dict().items()}}


def run_train_cli(case):
    """The train CLI's main on the CPU; returns its exit code and the
    paths this rank passed to ``torch.save``."""
    import multi_style_transfer_gan_tpu_torch.cli.train as cli

    writes = []
    real_save, real_available = torch.save, torch.cuda.is_available

    def save(obj, f, *args, **kwargs):
        writes.append(str(f))
        return real_save(obj, f, *args, **kwargs)

    cli.DEVICE = "cpu"
    torch.save, torch.cuda.is_available = save, (lambda: True)
    try:
        rc = cli.main(case["argv"])
    finally:
        torch.save, torch.cuda.is_available = real_save, real_available
    return {"rc": rc, "writes": writes}


RUNS = {"cyclegan": run_cyclegan, "pretrain": run_pretrain,
        "train_cli": run_train_cli}


def main(spec_path, out_dir):
    torch.set_num_threads(int(os.environ.get("WORKER_THREADS", "2")))
    device = mesh.init_data_parallel("cpu")
    try:
        if device != torch.device("cpu") or not mesh.active():
            raise RuntimeError(f"not in a gloo job on the CPU: {device}")
        spec = torch.load(spec_path, weights_only=True)
        results = {"rank": mesh.rank(), "world": mesh.world_size()}
        for case in spec["cases"]:
            with planted(case.get("fault")):
                results[case["name"]] = RUNS[case["kind"]](case)
        torch.save(results, os.path.join(out_dir, f"rank{mesh.rank()}.pt"))
    finally:
        mesh.close_data_parallel()


if __name__ == "__main__":
    main(*sys.argv[1:])
