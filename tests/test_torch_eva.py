"""The port's EVA-CLIP tower and its remat against the JAX package, on the CPU.

``eva_tiny_test`` (width 32, 2 layers, 2 heads of 16, patch 14) at 28², the
size ``tests/test_eva_parity.py`` uses, in fp32, weights drawn with numpy
and carried by the bridge. Tolerances: the token sequence at atol 1e-5
(two fp32 layers over activations of magnitude 1 to 5); every gradient of a
layer stack with remat on equal bit for bit to remat off (the recompute runs
the same ops). A size that is not a multiple of the patch is refused:
flax's convolution pads SAME there, the port's patch product only takes
VALID. A layer that draws (a dropout above 0) is refused under remat: the
recompute would draw another mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.modules.layers import Dropout, checkpointed
from antmmf_torch.modules.transformers.base import TransformerEncoder
from antmmf_torch.modules.vision.eva_vit import EVA_PRESETS as T_EVA_PRESETS
from antmmf_torch.modules.vision.eva_vit import EvaVisionTransformer as TEva
from antmmf_torch.utils.weights import export_flax_params, flatten_flax, load_flax_params
from antmmf_tpu.modules.vision.eva_vit import EVA_PRESETS as J_EVA_PRESETS
from antmmf_tpu.modules.vision.eva_vit import EvaVisionTransformer as JEva
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

SIZE, ATOL = 28, 1e-5
TINY = J_EVA_PRESETS["eva_tiny_test"]


def _random_params(module, *args, seed=0):
    params = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * 0.2
        return noise + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else noise

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def towers():
    images = np.random.default_rng(1).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    j_eva = JEva(image_size=SIZE, dtype=jnp.float32, **TINY)
    params = jax.device_get(_random_params(j_eva, jnp.asarray(images), seed=2))
    t_eva = TEva(image_size=SIZE, dtype=torch.float32, **TINY)
    load_flax_params(t_eva, params)
    return j_eva, params, t_eva, images


def test_presets_match_jax():
    assert T_EVA_PRESETS == J_EVA_PRESETS
    assert int(1408 * T_EVA_PRESETS["eva_vit_g"]["mlp_ratio"]) == 6144


def test_eva_sequence_matches_jax(towers):
    j_eva, params, t_eva, images = towers
    ref = np.asarray(j_eva.apply({"params": params}, jnp.asarray(images)))
    with torch.no_grad():
        out = t_eva(torch.as_tensor(images))
    assert out.shape == ref.shape == (2, (SIZE // 14) ** 2 + 1, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    # the carry both ways: the port's tree is JAX's, leaf for leaf
    exported = flatten_flax(export_flax_params(t_eva))
    assert sorted(exported) == sorted(flatten_flax(params))
    for path, leaf in flatten_flax(params).items():
        np.testing.assert_array_equal(exported[path], leaf, err_msg=path)


@pytest.mark.parametrize("size", [32, 30])
def test_a_size_off_the_patch_grid_is_refused(size):
    with pytest.raises(ValueError, match="not a multiple of the patch"):
        TEva(image_size=size, dtype=torch.float32, **TINY)


def _grads(module, x, remat):
    module.remat = remat
    for p in module.parameters():
        p.grad = None
    x = x.clone().requires_grad_()
    dy = torch.as_tensor(np.random.default_rng(3).standard_normal(tuple(x.shape)),
                         dtype=torch.float32)
    out = module(x)
    out = out["sequence"] if isinstance(out, dict) else out
    (out * dy[:, :out.shape[1]]).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in module.named_parameters()}, x.grad


@pytest.mark.parametrize("frozen_input", [False, True])
def test_remat_gives_the_same_gradients(towers, frozen_input):
    """EVA with remat on and off: the same output and every parameter's
    gradient bit for bit, also when the images need no gradient (the frozen
    tower's input, where a reentrant checkpoint would return none)."""
    _, _, t_eva, images = towers
    x = torch.as_tensor(images)
    if frozen_input:
        outs = []
        for remat in (False, True):
            t_eva.remat = remat
            for p in t_eva.parameters():
                p.grad = None
            t_eva(x).square().sum().backward()
            outs.append({n: p.grad.clone() for n, p in t_eva.named_parameters()})
        off, on = outs
    else:
        encoder = TransformerEncoder(32, 2, 2, activation="gelu_exact", dtype=torch.float32)
        seq = t_eva(x).detach()
        out_off, off, dx_off = _grads(encoder, seq, False)
        out_on, on, dx_on = _grads(encoder, seq, True)
        assert torch.equal(out_on, out_off) and torch.equal(dx_on, dx_off)
    t_eva.remat = False
    assert sorted(on) == sorted(off)
    for name in off:
        assert torch.equal(on[name], off[name]), name
        assert off[name].abs().max() > 0, name


@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_remat_refuses_a_layer_that_draws(rate):
    layer = torch.nn.Sequential(torch.nn.Linear(4, 4))
    layer.add_module("drop", Dropout(rate))
    x = torch.ones(2, 4, requires_grad=True)
    if rate:
        with pytest.raises(ValueError, match="dropout"):
            checkpointed(layer, x)
    else:
        checkpointed(layer, x).sum().backward()
        assert x.grad is not None
