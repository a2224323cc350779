"""The port's channel-attention and relayout plain versions vs the JAX
package's Pallas kernels of the same ops, in interpret mode on the CPU.

Packed rows (the packed engine's layout): ``packed_grouped_window_attention``,
``packed_window_attention_v3`` and ``packed_window_attention_pallas`` against
``packed_window_channel_attention_plain``. NHWC: ``window_attention_v4``,
``window_attention_v3_fused_io`` and the A/B script's ``window_attention_v6``
against ``window_channel_attention_plain``, whose kernel
(``csrc/window_channel_attention.cu``) covers them on the card. The Pallas
``s2d_rows`` / ``d2s_rows`` against the relayout's plain version.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from multi_style_transfer_gan_tpu.ops.packed import space_to_depth
from multi_style_transfer_gan_tpu_torch.ops.kernels import (
    depth_to_space_plain, packed_window_channel_attention_plain,
    space_to_depth_plain, window_channel_attention_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5


def _case(rng, C, shape=(2, 16, 16)):
    """NHWC x with one all-zero window, and (out, in) weights."""
    x = rng.standard_normal(shape + (C,)).astype(np.float32)
    x[0, :4, :4] = 0.0
    return (x, (rng.standard_normal((3 * C, C)) * 0.3).astype(np.float32),
            rng.standard_normal(3 * C).astype(np.float32),
            (rng.standard_normal((C, C)) * 0.3).astype(np.float32),
            rng.standard_normal(C).astype(np.float32))


def _jax_weights(wq, bq, wp, bp):
    """The JAX layout of the same weights: 1x1 HWIO kernels."""
    return (jnp.asarray(wq.T[None, None]), jnp.asarray(bq),
            jnp.asarray(wp.T[None, None]), jnp.asarray(bp))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def interpret(monkeypatch):
    """Run every pallas_call of the given modules in interpret mode."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    def patch(*modules):
        for mod in modules:
            monkeypatch.setattr(mod.pl, "pallas_call", interp)

    return patch


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("row", ["grouped", "v3", "per_phase"])
def test_packed_attention_plain_matches_pallas(rng, interpret, row, C):
    """TPU rows 5, 6 and 7: three Pallas kernels of one op on packed rows,
    one plain version (and one CUDA kernel) in the port."""
    import multi_style_transfer_gan_tpu.ops.pallas.packed_attention as pa
    from multi_style_transfer_gan_tpu.ops.pallas.window_attention_grouped \
        import packed_grouped_window_attention
    from multi_style_transfer_gan_tpu.ops.pallas.window_attention_v3 import (
        packed_window_attention_v3,
    )

    x, *w = _case(rng, C)
    xp = space_to_depth(jnp.asarray(x), 4)
    if row == "grouped":
        ref = packed_grouped_window_attention(xp, *_jax_weights(*w),
                                              interpret=True)
    elif row == "v3":
        ref = packed_window_attention_v3(xp, *_jax_weights(*w), interpret=True)
    else:
        interpret(pa)
        ref = pa.packed_window_attention_pallas(xp, *_jax_weights(*w))
    got = packed_window_channel_attention_plain(_t(np.asarray(xp)),
                                                *map(_t, w))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _ab_v6():
    path = os.path.join(REPO, "scripts", "ab_v6_attention.py")
    spec = importlib.util.spec_from_file_location("ab_v6_attention", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.window_attention_v6


@pytest.mark.parametrize("row", ["v4", "v3_fused_io", "v6"])
def test_nhwc_attention_plain_matches_the_other_pallas_layouts(rng, row):
    """TPU rows 8, 10 and 14 compute the NHWC LocalAttention of row 1."""
    from multi_style_transfer_gan_tpu.ops.pallas.window_attention_v4 import (
        window_attention_v4,
    )
    from multi_style_transfer_gan_tpu.ops.pallas.window_relayout import (
        window_attention_v3_fused_io,
    )

    fn = _ab_v6() if row == "v6" else {
        "v4": window_attention_v4,
        "v3_fused_io": window_attention_v3_fused_io}[row]
    x, *w = _case(rng, 16)
    ref = fn(jnp.asarray(x), *_jax_weights(*w), interpret=True)
    got = window_channel_attention_plain(_t(x), *map(_t, w))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("C", [3, 16])
def test_relayout_plain_matches_pallas_rows(rng, C):
    """TPU row 9: s2d_rows / d2s_rows are space_to_depth(x, 4) as
    (windows, 16C) rows."""
    from multi_style_transfer_gan_tpu.ops.pallas.window_relayout import (
        d2s_rows, s2d_rows,
    )

    x = rng.standard_normal((2, 16, 24, C)).astype(np.float32)
    rows = np.asarray(s2d_rows(jnp.asarray(x), interpret=True))
    packed = space_to_depth_plain(_t(x), 4)
    np.testing.assert_array_equal(packed.reshape(-1, 16 * C).numpy(), rows)
    back = np.asarray(d2s_rows(jnp.asarray(rows), x.shape, interpret=True))
    np.testing.assert_array_equal(depth_to_space_plain(packed, 4).numpy(), back)
