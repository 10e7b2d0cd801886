"""Cross-framework parity: HF torch BERT vs our flax BertEncoder after weight
import — the checkpoint-compatibility anchor (SURVEY §7 hard part 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

torch = pytest.importorskip("torch")

from antmmf_tpu.modules.encoders.text_encoder import BertEncoder
from antmmf_tpu.utils.torch_import import bert_state_dict_to_params


@pytest.fixture(scope="module")
def hf_pair():
    from transformers import BertConfig, BertModel

    cfg = BertConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        hidden_act="gelu",
    )
    torch.manual_seed(0)
    model = BertModel(cfg).eval()
    ours = BertEncoder(vocab_size=100, hidden_size=32, num_layers=2,
                       num_heads=2, max_position_embeddings=64,
                       dropout=0.0, dtype=jnp.float32)
    return model, ours


def test_bert_outputs_match_after_import(hf_pair):
    model, ours = hf_pair
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = bert_state_dict_to_params(sd, num_layers=2)

    ids = np.array([[2, 5, 7, 9, 0, 0]], np.int64)
    mask = np.array([[1, 1, 1, 1, 0, 0]], np.int64)
    seg = np.zeros_like(ids)

    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids),
                    attention_mask=torch.tensor(mask),
                    token_type_ids=torch.tensor(seg))
    out = ours.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                     jnp.asarray(seg))

    np.testing.assert_allclose(
        np.asarray(out["sequence_output"][:, :4]),
        ref.last_hidden_state.numpy()[:, :4], atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(out["pooled_output"]), ref.pooler_output.numpy(), atol=2e-4)


def test_import_covers_all_our_params(hf_pair):
    model, ours = hf_pair
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = bert_state_dict_to_params(sd, num_layers=2)
    init = jax.jit(ours.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    ref_paths = {"/".join(str(k.key) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(
                     init["params"])[0]}
    got_paths = {"/".join(str(k.key) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert ref_paths == got_paths


def test_clip_vit_outputs_match_after_import():
    """HF torch CLIPVisionModel vs our VisionTransformer after weight import."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    from antmmf_tpu.modules.vision.vit import VisionTransformer
    from antmmf_tpu.utils.torch_import import hf_clip_vision_state_dict_to_params

    cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=32, patch_size=16,
                           attention_dropout=0.0, hidden_act="quick_gelu")
    torch.manual_seed(0)
    ref = CLIPVisionModel(cfg).eval()
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    params = hf_clip_vision_state_dict_to_params(sd, num_layers=2)

    ours = VisionTransformer(image_size=32, patch_size=16, embed_dim=32,
                             num_layers=2, num_heads=2, quick_gelu=True,
                             dtype=jnp.float32)
    # structural check against a fresh init
    init = jax.jit(ours.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    ref_paths = {"/".join(str(k.key) for k in p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(
                     init["params"])[0]}
    got_paths = {"/".join(str(k.key) for k in p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert ref_paths == got_paths

    img = np.random.default_rng(0).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        hf_out = ref(pixel_values=torch.tensor(
            img.transpose(0, 3, 1, 2)))  # HF is NCHW
    out = ours.apply({"params": params}, jnp.asarray(img))
    # HF's last_hidden_state is pre-post_layernorm; our `sequence` is post.
    # pooler_output = post_layernorm(cls) — directly comparable to our CLS row.
    np.testing.assert_allclose(np.asarray(out["sequence"][:, 0]),
                               hf_out.pooler_output.numpy(), atol=3e-4)
