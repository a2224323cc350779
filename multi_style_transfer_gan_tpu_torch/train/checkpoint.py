"""Full train-state checkpoints for resume (port of ``train/checkpoint.py``).

Where the JAX package writes an orbax checkpoint, the port writes one
``torch.save`` of the whole state: both generators and discriminators with
their spectral-norm buffers, both Adam states and schedules, the step, the
image pools with their generator state, and the epoch. Layout:
``{dir}/step_{N}/state.pt``, beside which the CLI keeps the ``.pth``
exports; ``latest_step`` finds the resume point.
"""

from __future__ import annotations

import os
import re

import torch

_FILE = "state.pt"


def _pools_state(pools):
    (pool_a, pool_b), generator = pools
    return {"images": [pool_a.images.cpu(), pool_b.images.cpu()],
            "n": [pool_a.n, pool_b.n], "generator": generator.get_state()}


def _load_pools(pools, sd):
    (pool_a, pool_b), generator = pools
    for pool, images, n in zip((pool_a, pool_b), sd["images"], sd["n"]):
        pool.images.copy_(images)
        pool.n = int(n)
    generator.set_state(sd["generator"])


def save_train_state(state, directory, step: int, pools=None) -> str:
    """Write ``state`` (a CycleGANState) and ``pools`` (or None) to
    ``{directory}/step_{step}``; returns that path."""
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    blob = {"state": state.state_dict(), "epoch": step}
    if pools is not None:
        blob["pools"] = _pools_state(pools)
    tmp = os.path.join(path, f"{_FILE}.{os.getpid()}.tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, _FILE))  # never half a file
    return path


def latest_step(directory) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))
             and os.path.exists(os.path.join(directory, d, _FILE))]
    return max(steps) if steps else None


def restore_train_state(directory, step: int | None, state, pools=None):
    """Load checkpoint ``step`` (None: the latest) into ``state`` and
    ``pools`` in place. Returns ``(state, step)``, or ``((state, pools),
    step)`` when pools are given. A checkpoint written without pools leaves
    the given pools empty, and says so; one written with pools raises when
    none are given (the JAX CLI fails at that resume too) rather than drop
    them silently."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}", _FILE)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if pools is None and "pools" in blob:
        raise ValueError("checkpoint contains image-pool state; pass "
                         "--pool_size <N> to resume it")
    state.load_state_dict(blob["state"])
    if pools is None:
        return state, step
    if "pools" in blob:
        _load_pools(pools, blob["pools"])
    else:
        print("checkpoint has no pool state; resuming with a fresh (empty) "
              "image pool")
    return (state, pools), step
