"""The port's ``Dropout`` (``antmmf_torch/modules/layers.py``) by its statistics.

flax draws dropout masks from its ``dropout`` rng stream, which torch
cannot reproduce, so the port's masks are held to what flax's ``Dropout``
computes rather than to its bits: at rate 0.1 over 200,000 entries the
kept share lies within 5 binomial standard deviations of 0.9; every kept
entry is its input times 1/0.9 (to fp32 rounding: a few ulps) and every
dropped one 0, so the mean is kept; a deterministic call (evaluation) and
rate 0 are the identity; the same generator seed gives the same mask, and
the next draw of that generator another; the region encoder of
``univl_roi`` drops only in training. flax's own ``Dropout`` is run beside
it for the same statistics.
"""

import math

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from antmmf_torch.modules.encoders.image_feature_encoder import ImageFeatureEncoder
from antmmf_torch.modules.layers import Dropout

N, RATE = 200_000, 0.1
SIGMAS = 5


def _kept_share_bound():
    return SIGMAS * math.sqrt(RATE * (1 - RATE) / N)


def test_kept_share_within_five_sigma_and_scaled():
    x = torch.rand(N) + 0.5  # no zero among the inputs
    out = Dropout(RATE)(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - (1 - RATE)) <= _kept_share_bound()
    torch.testing.assert_close(out[kept], x[kept] / (1 - RATE), rtol=1e-6, atol=0)
    # the mean is kept: out − x has mean 0 and variance rate/(1 − rate)·E[x²]
    noise = math.sqrt(RATE / (1 - RATE) * x.pow(2).mean().item() / N)
    assert abs(out.mean().item() - x.mean().item()) <= SIGMAS * noise


def test_flax_dropout_has_the_same_statistics():
    x = np.random.default_rng(0).uniform(0.5, 1.5, N).astype(np.float32)
    out = np.asarray(fnn.Dropout(RATE).apply({}, x, deterministic=False,
                                             rngs={"dropout": jax.random.PRNGKey(0)}))
    kept = out != 0
    assert abs(kept.mean() - (1 - RATE)) <= _kept_share_bound()
    np.testing.assert_allclose(out[kept], x[kept] / (1 - RATE), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_and_rate_zero_are_the_identity(dtype):
    x = torch.randn(4, 7, 16).to(dtype)
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    assert Dropout(RATE)(x, deterministic=True, generator=gen) is x
    assert Dropout(0.0)(x, deterministic=False, generator=gen) is x
    assert torch.equal(gen.get_state(), state)  # nothing drawn
    out = Dropout(RATE)(x, deterministic=False, generator=gen)
    assert out.dtype == dtype and out.shape == x.shape


def test_same_seed_same_mask_next_draw_another():
    x = torch.ones(64, 128)
    drop = Dropout(RATE)
    a = drop(x, deterministic=False, generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    b = drop(x, deterministic=False, generator=gen)
    c = drop(x, deterministic=False, generator=gen)
    assert torch.equal(a, b)
    assert not torch.equal(b != 0, c != 0)


def test_rate_out_of_range_raises():
    with pytest.raises(ValueError, match="rate"):
        Dropout(1.0)


def test_region_encoder_drops_only_in_training():
    enc = ImageFeatureEncoder("spatial_projection", 16, 32, 5)
    assert enc.dropout.rate == 0.1  # the JAX default
    feats, boxes = torch.randn(8, 10, 16), torch.rand(8, 10, 5)
    with torch.no_grad():
        ev = enc(feats, boxes)
        tr = enc(feats, boxes, deterministic=False, generator=torch.Generator().manual_seed(0))
    kept = tr != 0
    assert (ev != 0).all()
    torch.testing.assert_close(tr[kept], ev[kept] / 0.9, rtol=1e-6, atol=1e-6)
    assert 0.8 < kept.float().mean().item() < 0.97
