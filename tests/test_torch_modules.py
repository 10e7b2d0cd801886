"""The port's modules (antmmf_torch/modules) against their flax counterparts.

Each test builds the flax module, replaces its parameters with seeded numpy
draws (so biases and norm scales are not trivially 0 and 1), carries them
into the port's module with ``load_flax_params`` and compares outputs on the
same seeded numpy inputs, in fp32 on the CPU, at atol 1e-5.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.modules import attention as t_attention
from antmmf_torch.modules import embeddings as t_emb
from antmmf_torch.modules import layers as t_layers
from antmmf_torch.modules.transformers.base import TransformerLayer as TLayer
from antmmf_torch.modules.vision.token_merging import tome_merge as t_tome
from antmmf_torch.utils.weights import flatten_flax, load_flax_params
from antmmf_tpu.modules import attention as j_attention
from antmmf_tpu.modules import embeddings as j_emb
from antmmf_tpu.modules import layers as j_layers
from antmmf_tpu.modules.transformers.base import TransformerLayer as JLayer
from antmmf_tpu.modules.vision.token_merging import tome_merge as j_tome

ATOL = 1e-5
F32 = torch.float32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_params(module, *args, seed=0):
    """flax params of ``module`` for ``args``, redrawn from a numpy generator."""
    params = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * 0.2
        return noise + 1.0 if name.endswith("['scale']") else noise

    return jax.tree_util.tree_map_with_path(draw, params)


def _run_jax(module, params, *args):
    return np.asarray(jax.jit(module.apply)({"params": params}, *args))


def _carry(module, params):
    load_flax_params(module, params)
    return module.eval()


def _close(port_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(port_out.detach().numpy(), jax_out, atol=atol, rtol=0)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm(eps):
    x = np.random.default_rng(1).standard_normal((3, 7, 48)).astype(np.float32) + 3.0
    jm = j_layers.LayerNorm(epsilon=eps, dtype=jnp.float32)
    params = _random_params(jm, x)
    port = _carry(t_layers.LayerNorm(48, eps, F32), params)
    _close(port(torch.from_numpy(x)), _run_jax(jm, params, x))


@pytest.mark.parametrize("activation", ["gelu", "gelu_exact", "quick_gelu"])
def test_mlp_activations(activation):
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(np.float32) * 2
    jm = j_layers.Mlp(hidden_dim=96, activation=activation, dtype=jnp.float32)
    params = _random_params(jm, x)
    port = _carry(t_layers.Mlp(32, 96, activation, F32), params)
    _close(port(torch.from_numpy(x)), _run_jax(jm, params, x))


def test_make_attention_mask():
    mask = np.array([[1, 1, 0], [1, 0, 0]])
    np.testing.assert_array_equal(
        t_layers.make_attention_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(j_layers.make_attention_mask(jnp.asarray(mask))))


def test_text_embeddings():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 100, size=(2, 11))
    seg = rng.integers(0, 2, size=(2, 11))
    jm = j_emb.TextEmbeddings(vocab_size=100, hidden_size=32, max_position_embeddings=40,
                              dtype=jnp.float32)
    params = _random_params(jm, ids, seg)
    port = _carry(t_emb.TextEmbeddings(100, 32, 40, dtype=F32), params)
    _close(port(torch.from_numpy(ids), torch.from_numpy(seg)), _run_jax(jm, params, ids, seg))


def test_visual_embeddings():
    images = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = j_emb.VisualEmbeddings(image_size=32, patch_size=16, embed_dim=24, dtype=jnp.float32)
    params = _random_params(jm, images)
    port = _carry(t_emb.VisualEmbeddings(32, 16, 24, F32), params)
    _close(port(torch.from_numpy(images)), _run_jax(jm, params, images))
    with pytest.raises(ValueError, match="not ported"):
        port(torch.zeros(1, 48, 48, 3))


def _bias(kind, B, L, rng):
    if kind is None:
        return None
    if kind == "pad":
        lens = np.array([L, L - 4])
        return np.array(j_layers.make_attention_mask(
            jnp.asarray((np.arange(L)[None] < lens[:, None]).astype(np.int32))))
    return np.log(rng.integers(1, 5, size=(B, L)).astype(np.float32))[:, None, None, :]


@pytest.mark.parametrize("norm_style,activation,eps,bias_kind", [
    ("pre", "quick_gelu", 1e-5, None),
    ("pre", "quick_gelu", 1e-5, "tome"),
    ("post", "gelu_exact", 1e-12, "pad"),
])
def test_transformer_layer(norm_style, activation, eps, bias_kind):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, 64)).astype(np.float32)
    bias = _bias(bias_kind, 2, 13, rng)
    jm = JLayer(num_heads=2, activation=activation, norm_style=norm_style,
                layer_norm_eps=eps, dtype=jnp.float32)
    params = _random_params(jm, x, bias)
    port = _carry(TLayer(64, 2, 4.0, activation, norm_style, eps, F32), params)
    out = port(torch.from_numpy(x), None if bias is None else torch.from_numpy(bias))
    _close(out, _run_jax(jm, params, x, bias))


def test_query_dependent_bias_takes_the_einsum_core():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 2, 9, 32)).astype(np.float32) for _ in range(3))
    causal = np.where(np.tril(np.ones((9, 9), bool)), 0.0, -1e30).astype(np.float32)[None, None]
    before = t_attention.small_attention.launches
    out = t_attention.attention_core(*(torch.from_numpy(a) for a in (q, k, v, causal)))
    ref = j_attention.attention_core(*(jnp.asarray(a) for a in (q, k, v, causal)))
    _close(out, np.asarray(ref))
    assert t_attention.small_attention.launches == before


@pytest.mark.parametrize("L,D,dtype,bias_kind", [
    (50, 64, torch.float16, None),
    (30, 48, torch.float32, "pad"),
    (257, 48, torch.bfloat16, None),
    (300, 64, torch.float16, "pad"),
])
def test_key_bias_attention_never_takes_the_einsum_core(L, D, dtype, bias_kind, monkeypatch):
    """A shape or dtype the kernels do not take reaches a kernel's wrapper
    (small attention to L = 256, flash beyond), which refuses it; the einsum
    core is kept for query- or head-dependent biases only."""
    def einsum_attention(*args, **kwargs):
        raise AssertionError("a key-bias attention took the einsum core")

    monkeypatch.setattr(t_attention, "einsum_attention", einsum_attention)
    q = torch.zeros(2, 2, L, D, dtype=dtype)
    bias = _bias(bias_kind, 2, L, np.random.default_rng(8))
    with pytest.raises(ValueError, match="(small|flash)_attention takes"):
        t_attention.attention_core(q, q, q, None if bias is None else torch.from_numpy(bias))


@pytest.mark.parametrize("r", [0, 1, 3])
def test_tome_merge(r):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    size = rng.integers(1, 4, size=(2, 11)).astype(np.float32)
    out, sizes = t_tome(torch.from_numpy(x), torch.from_numpy(size), r)
    j_out, j_sizes = j_tome(jnp.asarray(x), jnp.asarray(size), r)
    _close(out, np.asarray(j_out))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(j_sizes))


def test_weight_carry_refuses_mismatches():
    port = t_layers.Mlp(8, 16, "gelu", F32)
    good = {"fc1": {"kernel": np.zeros((8, 16)), "bias": np.zeros(16)},
            "fc2": {"kernel": np.zeros((16, 8)), "bias": np.zeros(8)}}
    load_flax_params(port, good)
    load_flax_params(port, flatten_flax(good))  # the params.npz form
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(port, {"fc1": good["fc1"]})
    with pytest.raises(KeyError, match="unused"):
        load_flax_params(port, {**good, "fc3": {"kernel": np.zeros((8, 8))}})
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(port, {**good, "fc2": {"kernel": np.zeros((8, 8)), "bias": np.zeros(8)}})


def test_port_imports_no_jax():
    """Importing every module of the port loads no jax, flax, orbax or
    antmmf_tpu module; chip_smoke.py imports none of them either."""
    mods = sorted(
        os.path.relpath(os.path.join(d, f), REPO)[:-3].replace(os.sep, ".")
        for d, _, files in os.walk(os.path.join(REPO, "antmmf_torch"))
        for f in files if f.endswith(".py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'orbax', 'antmmf_tpu')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "antmmf_torch.predictors.cli" in mods and "antmmf_torch.ops._build" in mods
    for new in ("ops.int4_matmul", "modules.qdense", "modules.lora", "modules.llm", "models.pink",
                "predictors.quantization", "predictors.generation_predictor",
                "utils.conversation", "datasets.processors.image_processors"):
        assert f"antmmf_torch.{new}" in mods, new

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in ("jax", "flax", "orbax", "antmmf_tpu")]
