"""M2-omni's towers and 3D RoPE in the port against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed; JAX parameters are drawn with numpy
too (every LoRA ``b`` and norm scale live) and carried into the port by the
weight bridge. fp32 throughout. Tolerances:

* the 3D RoPE tables against ``rope_cos_sin_3d`` at D=32 and D=128: atol
  1e-6 (fp32 cos/sin of the same angles); a text token at (p, p, p) gets the
  1D tables at p bit for bit, and the (16, 24, 24) bands at D=128;
* Qwen2-ViT at ``qwen2_vit_tiny_test`` (an image tiled to T=2 and a 4-frame
  video, non-square, LoRA off and on): the merged sequence at atol 1e-5 of
  its largest magnitude, ``grid_thw`` equal;
* SANM at ``sanm_tiny_test`` with a ragged ``audio_mask`` (a row fully
  masked but its first frame) and ``sanm_shift`` 0 and 1: atol 1e-5 of the
  largest magnitude;
* the conv ``AudioEncoder`` at odd and even T and F: atol 1e-5 of the
  largest magnitude; flax's SAME padding of a 3×3 stride-2 convolution is
  (0, 1) on an even size, where ``Conv2d(padding=1)`` would pad (1, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models import m2_omni as t_m2
from antmmf_torch.modules import llm as t_llm
from antmmf_torch.modules.encoders import sanm_audio as t_sanm
from antmmf_torch.modules.vision import qwen2_vit as t_q2
from antmmf_torch.utils.weights import load_flax_params
from antmmf_tpu.models import m2_omni as j_m2
from antmmf_tpu.modules import llm as j_llm
from antmmf_tpu.modules.encoders import sanm_audio as j_sanm
from antmmf_tpu.modules.vision import qwen2_vit as j_q2
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

RTOL = 1e-5  # of the reference's largest magnitude


def random_params(module, *args, seed=0, method=None):
    """flax params of ``module`` drawn with numpy: kernels and LoRA ``a`` at
    a standard deviation of fan-in^-½ (a scanned stack's leading dim is no
    fan-in), LoRA ``b`` from N(0, 0.02²), live but a correction as trained
    adapters are, norm scales around 1, everything else (biases,
    embeddings) from N(0, 0.2²)."""
    params = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, method=method),
                            *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if key.endswith("['scale']"):
            return 1.0 + 0.2 * noise
        if key.endswith(("['kernel']", "_lora_a']")):
            fan_in = np.prod(leaf.shape[1 if "['layers']" in key else 0:-1])
            return noise / np.float32(np.sqrt(fan_in))
        return (0.02 if key.endswith("_lora_b']") else 0.2) * noise

    return jax.device_get(jax.tree_util.tree_map_with_path(draw, params))


def assert_close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rtol * max(1.0, float(np.abs(ref).max())), rtol=0)


@pytest.mark.parametrize("head_dim", [32, 128])
def test_rope_3d_tables_match_jax(head_dim):
    pos = np.random.default_rng(1).integers(0, 700, (2, 19, 3))
    jc, js = j_llm.rope_cos_sin_3d(jnp.asarray(pos), head_dim)
    tc, ts = t_llm.rope_cos_sin_3d(torch.as_tensor(pos), head_dim)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    # text tokens at (p, p, p): exactly the 1D rotation at p
    p = torch.as_tensor(pos[..., 0])
    c3, s3 = t_llm.rope_cos_sin_3d(p[..., None].expand(-1, -1, 3), head_dim)
    c1, s1 = t_llm.rope_cos_sin(p, head_dim)
    assert torch.equal(c3, c1) and torch.equal(s3, s1)
    assert t_llm.mrope_sections(head_dim // 2) == j_llm.mrope_sections(head_dim // 2)
    if head_dim == 128:
        assert t_llm.mrope_sections(64) == (16, 24, 24)


@pytest.mark.parametrize("frames,lora", [(0, 0), (4, 0), (0, 2), (4, 2)])
def test_qwen2_vit_matches_jax(frames, lora):
    """frames 0: one image [B, H, W, 3], tiled to T=2 by the tower."""
    rng = np.random.default_rng(frames + lora)
    shape = (2, 16, 24, 3) if frames == 0 else (2, frames, 16, 24, 3)
    x = rng.standard_normal(shape).astype(np.float32)
    j_tower = j_q2.build_qwen2_vit("qwen2_vit_tiny_test", lora_rank=lora, dtype=jnp.float32)
    params = random_params(j_tower, jnp.asarray(x), seed=5)
    ref = jax.jit(lambda p, v: j_tower.apply({"params": p}, v))(params, jnp.asarray(x))
    t_tower = t_q2.build_qwen2_vit("qwen2_vit_tiny_test", lora_rank=lora, dtype=torch.float32)
    load_flax_params(t_tower, params)
    out = t_tower(torch.as_tensor(x))
    assert out["grid_thw"] == tuple(int(g) for g in ref["grid_thw"]) == (max(frames, 2) // 2,
                                                                          2, 3)
    assert_close(out["sequence"], ref["sequence"])
    frozen = {n for n, p in t_tower.named_parameters() if not p.requires_grad}
    assert len(frozen) == (2 * 4 * 2 if lora else 0)  # qkv/proj/fc1/fc2 weight+bias, 2 blocks


@pytest.mark.parametrize("shift", [0, 1])
def test_sanm_encoder_matches_jax(shift):
    rng = np.random.default_rng(6 + shift)
    feats = rng.standard_normal((3, 13, 24)).astype(np.float32)
    mask = (np.arange(13)[None] < np.array([13, 7, 1])[:, None]).astype(np.int32)
    j_enc = j_sanm.build_sanm_encoder("sanm_tiny_test", sanm_shift=shift, dtype=jnp.float32)
    params = random_params(j_enc, jnp.asarray(feats), jnp.asarray(mask), seed=7)
    ref = jax.jit(lambda p, f, m: j_enc.apply({"params": p}, f, m))(
        params, jnp.asarray(feats), jnp.asarray(mask))
    t_enc = t_sanm.build_sanm_encoder("sanm_tiny_test", sanm_shift=shift, dtype=torch.float32)
    load_flax_params(t_enc, params)
    out = t_enc(torch.as_tensor(feats), torch.as_tensor(mask))
    assert_close(out, ref)
    assert_close(t_sanm.compress_audio_tokens(out, 3),
                 j_sanm.compress_audio_tokens(jnp.asarray(ref), 3))


@pytest.mark.parametrize("T,F", [(16, 40), (15, 39)])
def test_conv_audio_encoder_matches_jax(T, F):
    rng = np.random.default_rng(T)
    fbank = rng.standard_normal((2, T, F)).astype(np.float32)
    j_enc = j_m2.AudioEncoder(hidden=32, dtype=jnp.float32)
    params = random_params(j_enc, jnp.asarray(fbank), seed=8)
    ref = jax.jit(lambda p, f: j_enc.apply({"params": p}, f))(params, jnp.asarray(fbank))
    t_enc = t_m2.AudioEncoder(32, feature_dim=F, dtype=torch.float32)
    load_flax_params(t_enc, params)
    assert_close(t_enc(torch.as_tensor(fbank)), ref)
    assert t_m2._same_pad(T) == ((0, 1) if T % 2 == 0 else (1, 1))
