"""Cross-attention, the decode cache and the caption decoder in the port
against the JAX package, on the CPU.

* ``MultiHeadAttention``: cross-attention with a key-padding bias
  (outputs, the gradient of every parameter and of both inputs),
  ``return_kv``, ``cached_kv`` and the one-token decode against a cache,
  whose every slot is compared after the in-place write (rows at the
  first, a middle and the last position);
* ``TransformerDecoder`` and ``LanguageDecoder``: the teacher-forced
  forward with every gradient, ``prime`` and ``decode_step`` (logits,
  every cache slot, and every parameter's gradient of a weighted sum of
  the step's logits);
* the router's structural rule, with the core that ran recorded: head
  widths outside the kernels' (96, 8) and decode-cache calls take the
  einsum core; D=64 at Lq ≠ Lk still takes ``flash_attention``, D=64 self-
  attention ``small_attention``; a kernel-eligible shape in a dtype the
  kernel refuses still raises.

The parameters are seeded numpy draws carried into the port by
``load_flax_params``. Tolerances (fp32 on both sides, sums in another
order): outputs, caches and logits at atol 1e-5; a parameter's gradient
within 1e-4 of its largest JAX entry, floored at 1e-2 of the module's
largest (the key projections' biases have an exact gradient of 0: the
softmax ignores a shift shared by every key, so both sides hold only
rounding there, up to 3e-7 of the largest entry through the flash route's
plain backward); an input's gradient within 1e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.modules import attention as t_attention
from antmmf_torch.modules import decoders as t_dec
from antmmf_torch.utils.weights import flatten_flax, flax_paths, load_flax_params, to_torch_layout
from antmmf_tpu.modules import attention as j_attention
from antmmf_tpu.modules import decoders as j_dec
from antmmf_tpu.modules.layers import make_attention_mask as j_mask
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

ATOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-2
F32 = torch.float32


def _random_params(module, *args, seed=0, method=None):
    """flax params of ``module`` for ``args``, redrawn from a numpy generator
    (norm scales around 1)."""
    init = module.init if method is None else (
        lambda *a: module.init(*a, method=method))
    params = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * 0.2
        return noise + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else noise

    return jax.tree_util.tree_map_with_path(draw, params)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, ref, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0,
                               err_msg=what)


def _grads_close(module, j_grads):
    """Every parameter's gradient against the JAX tree's, by flax path."""
    flat = flatten_flax(jax.device_get(j_grads))
    paths = flax_paths(module)
    assert sorted(paths.values()) == sorted(flat)
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in flat.values())
    for name, p in module.named_parameters():
        ref = to_torch_layout(paths[name], flat[paths[name]])
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        tol = GRAD_RTOL * max(float(np.abs(ref).max()), floor)
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=name)


def _pad_bias(B, Lk, rng):
    lens = rng.integers(Lk // 2, Lk + 1, B)
    lens[0] = Lk
    return np.asarray(j_mask(jnp.asarray((np.arange(Lk)[None] < lens[:, None]).astype(np.int32))))


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("C,H", [(16, 2), (128, 2)], ids=["D8", "D64"])
def test_cross_attention_and_its_gradients(C, H):
    rng = np.random.default_rng(C)
    B, Lq, Lk = 3, 5, 11
    x = rng.standard_normal((B, Lq, C)).astype(np.float32)
    kv = rng.standard_normal((B, Lk, C)).astype(np.float32)
    bias = _pad_bias(B, Lk, rng)
    w = rng.standard_normal((B, Lq, C)).astype(np.float32)
    jm = j_attention.MultiHeadAttention(num_heads=H, dtype=jnp.float32)
    params = _random_params(jm, x, kv, bias)

    def loss(params, x, kv):
        out = jm.apply({"params": params}, x, kv=kv, bias=bias)
        return (out * w).sum(), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        params, x, kv)
    port = t_attention.MultiHeadAttention(C, H, F32)
    load_flax_params(port, params)
    tx, tkv = (torch.tensor(a, requires_grad=True) for a in (x, kv))
    out = port(tx, torch.from_numpy(bias), kv=tkv)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, j_out)
    _grads_close(port, j_grads[0])
    _close(tx.grad, j_grads[1], GRAD_RTOL * float(np.abs(j_grads[1]).max()))
    _close(tkv.grad, j_grads[2], GRAD_RTOL * float(np.abs(j_grads[2]).max()))


def test_return_kv_and_cached_kv():
    rng = np.random.default_rng(1)
    B, Lq, Lk, C, H = 2, 3, 7, 24, 3
    x = rng.standard_normal((B, Lq, C)).astype(np.float32)
    memory = rng.standard_normal((B, Lk, C)).astype(np.float32)
    bias = _pad_bias(B, Lk, rng)
    jm = j_attention.MultiHeadAttention(num_heads=H, dtype=jnp.float32)
    params = _random_params(jm, x, memory, bias)
    v = {"params": params}
    j_kv = jm.apply(v, memory, kv=memory, return_kv=True)
    j_out = jm.apply(v, x, cached_kv=j_kv, bias=bias)
    port = t_attention.MultiHeadAttention(C, H, F32)
    load_flax_params(port, params)
    tm, tx, tb = _t(memory, x, bias)
    with torch.no_grad():
        t_kv = port(tm, kv=tm, return_kv=True)
        for got, ref in zip(t_kv, j_kv):
            assert tuple(got.shape) == (B, H, Lk, C // H)
            _close(got, ref)
        _close(port(tx, tb, cached_kv=t_kv), j_out)
        # the cached path is the full cross-attention without re-projecting
        _close(port(tx, tb, kv=tm), j_out)


def test_decode_cache_is_written_in_place_slot_by_slot():
    rng = np.random.default_rng(2)
    B, C, H, T = 3, 32, 4, 6
    x = rng.standard_normal((B, 1, C)).astype(np.float32)
    cache = {n: rng.standard_normal((B, H, T, C // H)).astype(np.float32) for n in ("k", "v")}
    pos = np.array([0, 3, T - 1], np.int32)
    jm = j_attention.MultiHeadAttention(num_heads=H, dtype=jnp.float32)
    params = _random_params(jm, x)
    j_out, j_cache = jm.apply({"params": params}, x, cache=cache, decode_pos=pos)
    port = t_attention.MultiHeadAttention(C, H, F32)
    load_flax_params(port, params)
    t_cache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    storage = {n: c.data_ptr() for n, c in t_cache.items()}
    with torch.no_grad():
        out, back = port(torch.from_numpy(x), cache=t_cache,
                         decode_pos=torch.from_numpy(pos).long())
    _close(out, j_out)
    assert back is t_cache and all(c.data_ptr() == storage[n] for n, c in back.items())
    for n in ("k", "v"):
        for b in range(B):
            for s in range(T):
                _close(back[n][b, :, s], j_cache[n][b, :, s], what=f"{n}[{b}, :, {s}]")
                if s != pos[b]:  # untouched slots keep their contents exactly
                    np.testing.assert_array_equal(back[n][b, :, s].numpy(), cache[n][b, :, s])


# ------------------------------------------------------------- decoders
V, C_DEC, H_DEC, LAYERS, MAXLEN = 50, 32, 4, 2, 9


def _decoder_case(seed):
    rng = np.random.default_rng(seed)
    B, L, Lk = 3, 7, 10
    tokens = rng.integers(0, V, (B, L))
    memory = rng.standard_normal((B, Lk, C_DEC)).astype(np.float32)
    mask = (np.arange(Lk)[None] < np.array([Lk, 6, 3])[:, None]).astype(np.int32)
    return rng, tokens, memory, mask


def _language_decoders(seed):
    rng, tokens, memory, mask = _decoder_case(seed)
    jm = j_dec.LanguageDecoder(vocab_size=V, hidden_size=C_DEC, num_layers=LAYERS,
                               num_heads=H_DEC, max_length=MAXLEN, dtype=jnp.float32)
    params = _random_params(jm, tokens, memory, mask, seed=seed)
    port = t_dec.LanguageDecoder(V, C_DEC, LAYERS, H_DEC, MAXLEN, dtype=F32)
    load_flax_params(port, params)
    return rng, tokens, memory, mask, jm, params, port


def test_transformer_decoder_forward_and_gradients():
    rng, tokens, memory, mask = _decoder_case(3)
    x = rng.standard_normal(tokens.shape + (C_DEC,)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jm = j_dec.TransformerDecoder(num_layers=LAYERS, num_heads=H_DEC, dtype=jnp.float32)
    params = _random_params(jm, x, memory, mask)

    def loss(params):
        out = jm.apply({"params": params}, x, memory, mask)
        return (out * w).sum(), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port = t_dec.TransformerDecoder(C_DEC, LAYERS, H_DEC, dtype=F32)
    load_flax_params(port, params)
    tx, tm, tmask, tw = _t(x, memory, mask, w)
    out = port(tx, tm, tmask)
    (out * tw).sum().backward()
    _close(out, j_out)
    _grads_close(port, j_grads)
    assert sorted(flatten_flax(params)) == sorted(flax_paths(port).values())


def test_language_decoder_forward_and_gradients():
    rng, tokens, memory, mask, jm, params, port = _language_decoders(4)
    w = rng.standard_normal(tokens.shape + (V,)).astype(np.float32)

    def loss(params):
        logits = jm.apply({"params": params}, tokens, memory, mask)
        return (logits * w).sum(), logits

    (_, j_logits), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    logits = port(*_t(tokens, memory, mask))
    assert logits.dtype == torch.float32 and tuple(logits.shape) == tokens.shape + (V,)
    (logits * torch.from_numpy(w)).sum().backward()
    _close(logits, j_logits)
    _grads_close(port, j_grads)


def test_prime_and_decode_step_with_gradients():
    """Two decode steps from empty caches at rows' own positions, then the
    second step's weighted logits differentiated."""
    rng, tokens, memory, mask, jm, params, port = _language_decoders(5)
    B = tokens.shape[0]
    v = {"params": params}
    j_kvs = jax.jit(lambda v, mem: jm.apply(v, mem, method=lambda m, mem: m.prime(mem)))(
        v, memory)
    with torch.no_grad():  # primed once per request, outside the step's graph
        t_kvs = port.prime(torch.from_numpy(memory))
    assert len(t_kvs) == LAYERS
    for (tk, tv), (jk, jv) in zip(t_kvs, j_kvs):
        _close(tk, jk)
        _close(tv, jv)
    hd = C_DEC // H_DEC
    j_caches = [{n: jnp.zeros((B, H_DEC, MAXLEN, hd)) for n in ("k", "v")} for _ in range(LAYERS)]
    t_caches = [{n: torch.zeros(B, H_DEC, MAXLEN, hd) for n in ("k", "v")} for _ in range(LAYERS)]
    step = lambda m, t, p, c, k, mm: m.decode_step(t, p, c, k, mm)  # noqa: E731
    w = rng.standard_normal((B, V)).astype(np.float32)
    for i, pos in enumerate((np.array([0, 2, 5]), np.array([1, 3, MAXLEN - 1]))):
        tok = tokens[:, i]
        if i == 0:
            j_logits, j_caches = jax.jit(lambda *a: jm.apply(v, *a, method=step))(
                tok, pos, j_caches, j_kvs, mask)
            with torch.no_grad():
                t_logits, t_caches = port.decode_step(
                    *_t(tok, pos), t_caches, t_kvs, torch.from_numpy(mask))
        else:
            def loss(params):
                logits, caches = jm.apply({"params": params}, tok, pos, j_caches, j_kvs, mask,
                                          method=step)
                return (logits * w).sum(), (logits, caches)

            (_, (j_logits, j_caches)), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                params)
            t_logits, t_caches = port.decode_step(*_t(tok, pos), t_caches, t_kvs,
                                                  torch.from_numpy(mask))
            (t_logits * torch.from_numpy(w)).sum().backward()
        _close(t_logits, j_logits, what=f"step {i}")
        for layer, (tc, jc) in enumerate(zip(t_caches, j_caches)):
            for n in ("k", "v"):
                _close(tc[n], jc[n], what=f"step {i} layer {layer} {n}")
    # the memory k/v were primed outside the graph: the cross-attention's
    # k/v projections get no gradient on either side
    _grads_close(port, j_grads)


# ------------------------------------------------------------- the router
def _record(monkeypatch):
    calls = []
    for name in ("einsum_attention", "small_attention", "flash_attention"):
        real = getattr(t_attention, name)
        monkeypatch.setattr(t_attention, name,
                            lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a, **kw))
    return calls


@pytest.mark.parametrize("Lq,Lk,D,bias,core", [
    (40, 40, 96, "pad", "einsum_attention"),
    (40, 400, 96, "pad", "einsum_attention"),
    (1, 400, 96, "pad", "einsum_attention"),
    (300, 300, 96, None, "einsum_attention"),
    (9, 9, 8, None, "einsum_attention"),
    (40, 400, 64, "pad", "flash_attention"),
    (1, 60, 64, None, "flash_attention"),
    (50, 50, 64, "pad", "small_attention"),
    (300, 300, 64, "pad", "flash_attention"),
], ids=["d96_self", "d96_cross", "d96_decode_cross", "d96_long", "d8", "d64_cross",
        "d64_one_query", "d64_self", "d64_long"])
def test_router_sends_head_widths_by_structure(Lq, Lk, D, bias, core, monkeypatch):
    calls = _record(monkeypatch)
    q, k = torch.zeros(2, 2, Lq, D), torch.zeros(2, 2, Lk, D)
    b = None if bias is None else torch.from_numpy(_pad_bias(2, Lk, np.random.default_rng(0)))
    assert t_attention.attention_core(q, k, k, b).shape == q.shape
    assert calls == [core]


def test_decode_cache_call_takes_the_einsum_core_at_a_kernel_width(monkeypatch):
    """D=64 against a cache of 40 slots: a key bias with Lq ≠ Lk, which the
    flash kernels take, but a decode call goes to the einsum core."""
    calls = _record(monkeypatch)
    port = t_attention.MultiHeadAttention(128, 2, F32)
    cache = {n: torch.zeros(3, 2, 40, 64) for n in ("k", "v")}
    with torch.no_grad():
        port(torch.zeros(3, 1, 128), cache=cache, decode_pos=torch.tensor([0, 5, 39]))
        assert calls == ["einsum_attention"]
        port(torch.zeros(3, 7, 128), kv=torch.zeros(3, 40, 128))
    assert calls == ["einsum_attention", "flash_attention"]


@pytest.mark.parametrize("Lq,Lk", [(50, 50), (30, 40)])
def test_a_refused_dtype_at_a_kernel_width_still_raises(Lq, Lk, monkeypatch):
    """float16 at D=64 is inside the routing rule's kernel widths: the
    kernel's wrapper refuses it, and nothing catches that for the einsum core."""
    calls = _record(monkeypatch)
    q, k = torch.zeros(1, 2, Lq, 64, dtype=torch.float16), torch.zeros(1, 2, Lk, 64,
                                                                        dtype=torch.float16)
    with pytest.raises(ValueError, match="(small|flash)_attention takes"):
        t_attention.attention_core(q, k, k)
    assert "einsum_attention" not in calls


def test_causal_bias_matches_jax():
    np.testing.assert_array_equal(t_dec.causal_bias(7).numpy(), np.asarray(j_dec.causal_bias(7)))


@pytest.mark.parametrize("cls,args", [(t_dec.TransformerDecoderLayer, (32, 4)),
                                      (t_dec.TransformerDecoder, (32, 2, 4)),
                                      (t_dec.LanguageDecoder, (50, 32, 2, 4, 9))])
def test_decoder_dropout_raises_with_its_rate(cls, args):
    """Dropout is ported: each decoder layer drops its self- and
    cross-attention output and its MLP's activations at the given rate."""
    from antmmf_torch.modules.layers import Dropout

    module = cls(*args, dropout=0.1)
    drops = [m for m in module.modules() if isinstance(m, Dropout)]
    layers = [m for m in module.modules() if isinstance(m, t_dec.TransformerDecoderLayer)]
    assert layers and len(drops) == 3 * len(layers) and {m.rate for m in drops} == {0.1}
