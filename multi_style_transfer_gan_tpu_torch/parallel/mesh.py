"""Data parallelism over ranks (port of ``parallel/mesh.py``).

Where the JAX package shards the global batch over a device mesh and lets
GSPMD insert the gradient all-reduce, the port runs one process per GPU
under ``torchrun`` (``python -m torch.distributed.run``) and makes the
collectives itself on the default ``torch.distributed`` process group:
NCCL on the card, gloo on the CPU. ``--batch_size`` stays the global
batch. Rank r holds block r of it (the layout of JAX's sharded batch axis),
and an N-rank step computes what the one-device step computes on the whole
global batch.

Every collective here does nothing without a process group (``active()``
is false when the process was not started by torchrun), so a
single-process run executes the code it ran before data parallelism.

The batch CLI's ``--data_parallel`` is the single-process mode of the JAX
package's ``make_mesh()``: one replica of the program on every local
device (``local_devices``), each taking a block of every batch
(``pipelines.batch_process(devices=...)``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

# the environment torchrun gives each process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def active() -> bool:
    """Whether this process belongs to a data-parallel job (a default
    process group exists)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_writer() -> bool:
    """True on rank 0 only: the one process that writes checkpoints and
    metrics (the JAX CLIs' ``jax.process_index() == 0``)."""
    return rank() == 0


def init_data_parallel(device="cuda") -> torch.device:
    """Join the torchrun job this process was started in, and return the
    device it trains on.

    Under torchrun (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) a CUDA
    ``device`` becomes ``cuda:LOCAL_RANK``, made the current device before
    the NCCL process group starts; a CPU device joins a gloo group. Without
    that environment: world 1, no process group, ``device`` itself.
    Calling it again in a process that has joined returns the same device.
    ``close_data_parallel`` leaves the job."""
    device = torch.device(device)
    if not all(k in os.environ for k in TORCHRUN_ENV):
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if not active():
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    return device


def close_data_parallel() -> None:
    """Destroy the default process group, where there is one."""
    if active():
        dist.destroy_process_group()


def local_batch_size(global_batch: int, world: int) -> int:
    """The batch each of ``world`` ranks takes. Under torchrun no rank can be
    left out (the JAX package's multi-host rule, mesh.py:51-56), so a global
    batch that ``world`` does not divide raises, with JAX's message."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data axis size {world}")
    return global_batch // world


def rank_block(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global batch (leading axis), the identity
    without a process group."""
    n = local_batch_size(x.shape[0], world_size())
    r = rank()
    return x[r * n:(r + 1) * n]


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's block ``x`` (concatenated in rank
    order along the leading axis); ``x`` itself without a process group.
    Not differentiable."""
    if not active():
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradients over the ranks:
    each rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (out of place; ``x``
    itself without a process group)."""
    return _AllReduceSum.apply(x) if active() else x


def _memory_order(t: torch.Tensor):
    """A 1-D view of ``t``'s elements in the order they lie in memory
    (contiguous or channels-last), or None where there is none."""
    if t.is_contiguous():
        return t.view(-1)
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1).reshape(-1)
    return None


def _flat_collective_(tensors, collective) -> None:
    """Run ``collective`` in place on one flat buffer per (dtype, device) of
    ``tensors`` and copy the result back into each tensor. Each tensor
    enters the buffer in its memory order (every rank lays a tensor out
    alike), so the copies are one concatenation and one multi-tensor copy
    back, whatever the layouts (channels-last weights included); a tensor
    of another layout goes in logical order."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        views = [_memory_order(t) for t in group]
        flat = torch.cat([t.reshape(-1) if v is None else v
                          for t, v in zip(group, views)])
        collective(flat)
        parts = flat.split([t.numel() for t in group])
        direct = [(v, p) for v, p in zip(views, parts) if v is not None]
        if direct:
            torch._foreach_copy_([v for v, _ in direct],
                                 [p for _, p in direct])
        for t, v, p in zip(group, views, parts):
            if v is None:
                t.copy_(p.view(t.shape))


@torch.no_grad()
def all_reduce_mean_(tensors) -> None:
    """Average ``tensors`` over the ranks in place: one all-reduce (a sum)
    a dtype, then a division by the world size. Nothing without a process
    group."""
    if not active():
        return
    world = world_size()

    def mean_(flat):
        dist.all_reduce(flat)
        flat.div_(world)

    _flat_collective_(list(tensors), mean_)


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, src: int = 0):
    """Every parameter and buffer of ``module`` (spectral norm's ``u`` and
    ``v``, BatchNorm's running statistics and counts among them) set to
    rank ``src``'s, in place: the JAX package's ``replicate_tree``.
    Returns ``module``."""
    if active():
        _flat_collective_([*module.parameters(), *module.buffers()],
                          lambda flat: dist.broadcast(flat, src))
    return module


def local_devices() -> list[torch.device]:
    """Every CUDA device of this host, in order: the device list of the
    batch CLI's ``--data_parallel`` (JAX's ``make_mesh()`` over
    ``jax.devices()``)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
