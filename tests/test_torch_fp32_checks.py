"""chip_smoke.py's fp32 training checks, rehearsed on the CPU.

The card-vs-CPU pretrain check holds the losses of two fp32 enhanced
pretrain steps and the first step's gradient norms; its negative control
reruns the card's half under each of ``chip_smoke.PLANTED_FAULTS``, which
must fail it. Here both halves run on the CPU (the wrappers take their
plain versions), so the clean check reads 0 and each planted fault must
still land past the limit. ``devtools/fp32_step_spread.py`` evaluates the
checks in float64 as their reference: every operation of that evaluation
must return float64.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from devtools import fp32_step_spread as spread


@pytest.mark.parametrize("channels", [8, 72])
def test_pretrain_check_sees_each_planted_fault(channels):
    """c8 (row 11, row 12 at 1 head) and c72 (the route, row 12 at 9
    heads) at 32^2: the check passes clean and ``sees_fault`` holds for
    each planted fault (it raises otherwise)."""
    smoke.fp32_pretrain_card_vs_cpu(
        np.random.default_rng(0), "cpu", channels,
        torch.Generator().manual_seed(1), f"[c{channels}]", size=32)


def test_planted_faults_are_undone():
    """Each fault doubles a gradient only inside its block: after it the
    backward is the same function again."""
    import importlib

    fns = [importlib.import_module(
        f"multi_style_transfer_gan_tpu_torch.ops.kernels.{m}").__dict__[c]
        for m, c in (("window_mhsa_train", "_WindowMHSA"),
                     ("window_attention_train", "_WindowAttentionMid"),
                     ("window_attention_fast_vjp", "_FastVJP"))]
    before = [f.backward for f in fns]
    for fault in smoke.PLANTED_FAULTS:
        with smoke.planted_fault(fault):
            assert any(f.backward is not b for f, b in zip(fns, before))
        assert all(f.backward is b for f, b in zip(fns, before))
    with pytest.raises(ValueError):
        with smoke.planted_fault("no such fault"):
            pass


@pytest.mark.parametrize("kind", ["step", "pretrain"])
def test_float64_reference_is_float64_throughout(kind):
    """The checks' float64 evaluation at c8, 32^2: no operation returns
    fp32 or bf16, and its losses lie within fp32's rounding of the fp32
    evaluation's."""
    ref, ref_norms, narrow = spread.losses(f"8:32:{kind}:warm", "float64", 2)
    got, norms, _ = spread.losses(f"8:32:{kind}:warm", "float32", 2)
    assert narrow == 0
    assert spread.rel(got, ref) < 1e-5
    assert len(norms) == len(ref_norms) and max(ref_norms) > 0
