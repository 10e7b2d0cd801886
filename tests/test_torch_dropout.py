"""The port's ``Dropout`` and ``DropPath`` (``antmmf_torch/modules/layers.py``)
by their statistics, and dropout and stochastic depth in the ported models.

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

``DropPath`` keeps or drops whole samples: at rate 0.1 over 20,000 samples
the kept share lies within 4 binomial standard deviations of 0.9, as
flax's ``DropPath`` does, and every kept sample is its input times 1/0.9.
The per-layer rates of a stack equal JAX's, read from the built modules
(the linear ramp ``rate · i / max(1, n − 1)``, uniform under
``scan_layers``). Each model that takes ``dropout`` (retrieval with its
cross-encoder, pretraining, ROI, DMAE, captioning, classification): at
rate 0 a training forward equals evaluation at atol 0 and draws nothing;
at 0.1 evaluation equals the rate-0 model's at atol 0, while a training
forward draws from the generator it is given (the same seed, the same
output). ``antmmf_torch.run`` trains ``video_retrieval.local.yml`` with
``dropout`` and ``drop_path`` 0.1 laid on by opts for 2 steps with finite
losses (JAX's UniVL has no ``drop_path`` field, so both ignore it).
"""

import copy
import math
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch import run
from antmmf_torch.models.base_model import build_model
from antmmf_torch.modules.encoders.image_feature_encoder import ImageFeatureEncoder
from antmmf_torch.modules.layers import Dropout, DropPath
from antmmf_torch.modules.transformers.base import TransformerEncoder
from antmmf_torch.modules.vision.vit import VisionTransformer
from antmmf_tpu.modules import layers as j_layers
from antmmf_tpu.modules.transformers.base import TransformerEncoder as JTransformerEncoder
from antmmf_tpu.modules.vision.vit import VisionTransformer as JVisionTransformer
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


# ---------------------------------------------------------------- DropPath
SAMPLES, PATH_SIGMAS = 20_000, 4


def _sample_share_bound():
    return PATH_SIGMAS * math.sqrt(RATE * (1 - RATE) / SAMPLES)


def test_drop_path_keeps_whole_samples_within_four_sigma_and_scales():
    x = torch.rand(SAMPLES, 3, 5) + 0.5
    out = DropPath(RATE)(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    kept = (out != 0).reshape(SAMPLES, -1)
    assert torch.equal(kept.all(1), kept.any(1))  # a sample is kept or dropped whole
    share = kept.all(1).float().mean().item()
    assert abs(share - (1 - RATE)) <= _sample_share_bound()
    torch.testing.assert_close(out[kept.all(1)], x[kept.all(1)] / (1 - RATE), rtol=1e-6, atol=0)
    # flax's DropPath: the same statistics
    xj = np.random.default_rng(0).uniform(0.5, 1.5, (SAMPLES, 3, 5)).astype(np.float32)
    outj = np.asarray(j_layers.DropPath(RATE).apply({}, xj, deterministic=False,
                                                    rngs={"dropout": jax.random.PRNGKey(0)}))
    keptj = (outj != 0).reshape(SAMPLES, -1)
    assert (keptj.all(1) == keptj.any(1)).all()
    assert abs(keptj.all(1).mean() - (1 - RATE)) <= _sample_share_bound()


def test_drop_path_is_the_identity_in_evaluation_and_at_rate_zero():
    x = torch.randn(6, 4, 8)
    gen = torch.Generator().manual_seed(2)
    state = gen.get_state()
    assert DropPath(RATE)(x, deterministic=True, generator=gen) is x
    assert DropPath(RATE)(x) is x  # outside a training forward's draws
    assert DropPath(0.0)(x, deterministic=False, generator=gen) is x
    assert torch.equal(gen.get_state(), state)
    with pytest.raises(ValueError, match="drop_path"):
        DropPath(1.0)


def _jax_drop_path_rates(module, x):
    """The rate of every DropPath call while flax traces ``module``'s init."""
    rates = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, j_layers.DropPath) and context.method_name == "__call__":
            rates.append(context.module.rate)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    return rates


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan_layers"])
def test_drop_path_rates_per_layer_match_jax(scan):
    n, rate = 5, 0.2
    port = TransformerEncoder(16, n, 2, drop_path=rate, scan_layers=scan, device="cpu")
    got = [getattr(port, f"layer_{i}").drop_path.rate for i in range(n)]
    ref = _jax_drop_path_rates(JTransformerEncoder(num_layers=n, num_heads=2, drop_path=rate,
                                                   scan_layers=scan), jnp.zeros((1, 3, 16)))
    # each layer drops its attention and its MLP branch; the scanned body is
    # traced once
    per_layer = ref[0::2] if not scan else ref[:1] * n
    assert ref == [r for r in per_layer for _ in range(2)][:len(ref)]
    np.testing.assert_allclose(got, per_layer, rtol=1e-7, atol=0)
    expected = [rate] * n if scan else [rate * i / (n - 1) for i in range(n)]
    np.testing.assert_allclose(got, expected, rtol=1e-7, atol=0)
    # the ViT hands its drop_path to its stack, as JAX's does
    vit = VisionTransformer(image_size=32, patch_size=16, embed_dim=16, num_layers=n,
                            num_heads=2, drop_path=rate, scan_layers=scan, device="cpu")
    j_vit = _jax_drop_path_rates(JVisionTransformer(image_size=32, patch_size=16, embed_dim=16,
                                                    num_layers=n, num_heads=2, drop_path=rate,
                                                    scan_layers=scan),
                                 jnp.zeros((1, 32, 32, 3)))
    assert [getattr(vit.encoder, f"layer_{i}").drop_path.rate for i in range(n)] == got
    assert j_vit == ref


# ------------------------------------------------------------------ models
TINY = dict(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", image_size=32,
            embed_dim=32, dtype_str="float32")
MODELS = {
    "univl_retrieval": dict(with_cross_encoder=True, cross_layers=2),
    "univl_pretrain": dict(cross_layers=2),
    "univl_roi": dict(cross_layers=2, region_dim=16),
    "dmae_retrieval": dict(temporal_layers=2),
    "univl_caption": dict(decoder_layers=2, decoder_heads=2, max_caption_len=12),
    "univl_classification": dict(num_labels=3),
}


def _model_batch(seed=0, B=3, L=10, frames=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, 30000, (B, L))
    mask = (np.arange(L)[None] < np.array([[L], [7], [5]])).astype(np.int64)
    ids = ids * mask
    return {k: torch.as_tensor(v) for k, v in dict(
        caption_input_ids=ids, caption_input_mask=mask, caption_raw_input_ids=ids,
        caption_lm_label_ids=np.where(rng.random((B, L)) < 0.3, ids, -1) * mask - (1 - mask),
        caption_segment_ids=np.zeros_like(ids),
        image_data=rng.standard_normal((B, frames, 32, 32, 3)).astype(np.float32),
        ocr_input_ids=rng.integers(1000, 30000, (B, 6)), ocr_input_mask=np.ones((B, 6), np.int64),
        targets=rng.integers(0, 3, B)).items()}


def _model(name, dropout):
    config = {"model_attributes": {name: {**TINY, **MODELS[name], "dropout": dropout}}}
    return build_model(config, device="cpu").module


def _outputs(module, batch, deterministic, generator=None):
    torch.manual_seed(0)  # no draw may come from the global generator either
    with torch.no_grad():
        out = module(batch, deterministic=deterministic, generator=generator)
    flat = {f"losses/{k}": v for k, v in out.get("losses", {}).items()}
    flat.update({k: v for k, v in out.items() if isinstance(v, torch.Tensor)})
    return flat


def _assert_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", list(MODELS))
def test_model_dropout_draws_only_in_training(name):
    batch = _model_batch()
    # rate 0: a training forward is evaluation, and draws nothing
    off = _model(name, 0.0)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    ev = _outputs(off, batch, True)
    _assert_equal(_outputs(off, batch, False, gen), ev)
    assert torch.equal(gen.get_state(), state)
    # rate 0.1 on the same weights: evaluation unchanged, training draws
    on = _model(name, 0.1)
    on.load_state_dict(copy.deepcopy(off.state_dict()))
    rates = {m.rate for m in on.modules() if isinstance(m, Dropout)}
    assert 0.1 in rates and rates <= {0.0, 0.1}
    _assert_equal(_outputs(on, batch, True), ev)
    a = _outputs(on, batch, False, torch.Generator().manual_seed(5))
    b = _outputs(on, batch, False, torch.Generator().manual_seed(5))
    _assert_equal(a, b)  # the generator alone decides the masks
    gen = torch.Generator().manual_seed(5)
    c = _outputs(on, batch, False, gen)
    assert not torch.equal(gen.get_state(), state)
    assert any(not torch.equal(c[k], ev[k]) for k in ev if k.startswith("losses/"))
    assert all(torch.isfinite(v).all() for k, v in c.items() if k.startswith("losses/"))


def test_cli_trains_the_fixture_with_dropout_and_drop_path(tmp_path):
    config = os.path.join(REPO, "projects", "base_vtp", "configs", "video_retrieval.local.yml")
    trainer = run.main(["--config", config, "training_parameters.device", "cpu",
                        "training_parameters.save_dir", str(tmp_path),
                        "training_parameters.max_iterations", "2",
                        "training_parameters.log_interval", "1",
                        "training_parameters.snapshot_interval", "2",
                        "training_parameters.seed", "3",
                        "model_attributes.univl_retrieval.dropout", "0.1",
                        "model_attributes.univl_retrieval.drop_path", "0.1"])
    assert trainer.state.step == 2
    module = trainer.shell.module
    assert {m.rate for m in module.modules() if isinstance(m, Dropout)} == {0.1}
    assert all(m.rate == 0.0 for m in module.modules() if isinstance(m, DropPath))
    losses = list(trainer.meter.meters["train/total_loss"].deque)
    assert len(losses) == 2 and all(np.isfinite(losses))
