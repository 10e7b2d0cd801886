"""The port's small-attention op (antmmf_torch/ops/small_attention.py) against
the JAX package's attention cores, on the CPU.

The CUDA kernel itself runs only on a card (chip_smoke.py holds it against
``plain_small_attention`` there); here the plain version, which the wrapper
takes for CPU tensors, is held against ``xla_attention_core`` (the function
the JAX package runs on this path) and, where that kernel masks its padding
(an explicit bias), against the Pallas ``small_attention`` in interpret mode.
Tolerance: atol 2e-5 in fp32, the bound of tests/test_flash_attention.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.ops import small_attention as port
from antmmf_tpu.modules.attention import xla_attention_core

ATOL = 2e-5
B, H, D = 2, 3, 32


def _inputs(L, bias_kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(3))
    if bias_kind is None:
        bias = None
    elif bias_kind == "pad":
        lens = rng.integers(1, L + 1, size=B)
        lens[0] = L
        mask = np.arange(L)[None] < lens[:, None]
        bias = np.where(mask, 0.0, np.finfo(np.float32).min).astype(np.float32)
        bias = bias[:, None, None, :]
    else:  # ToMe proportional attention: log(token size)
        size = rng.integers(1, 9, size=(B, L)).astype(np.float32)
        bias = np.log(size)[:, None, None, :]
    return q, k, v, bias


def _port(q, k, v, bias):
    t = torch.from_numpy
    out = port.small_attention(t(q), t(k), t(v), None if bias is None else t(bias))
    return out.numpy()


@pytest.mark.parametrize("bias_kind", [None, "pad", "tome"])
@pytest.mark.parametrize("L", [50, 30, 13, 1])
def test_plain_matches_xla_core(L, bias_kind):
    q, k, v, bias = _inputs(L, bias_kind)
    ref = xla_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None if bias is None else jnp.asarray(bias))
    np.testing.assert_allclose(_port(q, k, v, bias), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("bias_kind", ["pad", "tome"])
@pytest.mark.parametrize("L", [50, 13])
def test_plain_matches_pallas_interpret(L, bias_kind, monkeypatch):
    from jax.experimental import pallas as pl

    import antmmf_tpu.ops.pallas.small_attention as sa

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    q, k, v, bias = _inputs(L, bias_kind, seed=1)
    ref = sa.small_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             bias=jnp.asarray(bias))
    np.testing.assert_allclose(_port(q, k, v, bias), np.asarray(ref), atol=ATOL)


def test_fully_masked_row_is_uniform_average():
    q, k, v, _ = _inputs(50, None, seed=2)
    bias = np.zeros((B, 1, 1, 50), np.float32)
    bias[0] = np.finfo(np.float32).min
    out = _port(q, k, v, bias)
    ref = xla_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[0], np.broadcast_to(v[0].mean(1, keepdims=True), v[0].shape),
                               atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


def test_bf16_casts_probabilities_before_pv():
    q, k, v, bias = _inputs(30, "pad", seed=3)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    out = port.small_attention(*bf, torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    ref = xla_attention_core(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in bf),
                             jnp.asarray(bias))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = port.small_attention.launches
    q, k, v, bias = _inputs(13, "pad", seed=4)
    np.testing.assert_array_equal(
        _port(q, k, v, bias),
        port.plain_small_attention(*(torch.from_numpy(x) for x in (q, k, v, bias))).numpy())
    assert port.small_attention.launches == before


def test_non_cpu_tensors_never_fall_back():
    q = torch.empty(2, 3, 13, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.small_attention(q, q, q)


@pytest.mark.parametrize("L,D,dtype,takes", [
    (50, 64, torch.bfloat16, True),
    (256, 128, torch.bfloat16, True),
    (215, 128, torch.float32, True),
    (1, 32, torch.float32, True),
    (257, 64, torch.bfloat16, False),
    (50, 48, torch.bfloat16, False),
    (50, 64, torch.float16, False),
])
def test_kernel_contract(L, D, dtype, takes):
    """The wrapper holds the kernel's contract on the CPU too: what it takes
    runs the plain version, anything else raises instead of computing."""
    q = torch.zeros(1, 2, L, D, dtype=dtype)
    if takes:
        assert port.small_attention(q, q, q).shape == q.shape
    else:
        with pytest.raises(ValueError, match="small_attention takes"):
            port.small_attention(q, q, q)


@pytest.mark.parametrize("bias_shape", [(2, 1, 50, 50), (2, 3, 1, 50), (2, 49)])
def test_query_or_head_biases_are_refused(bias_shape):
    q = torch.zeros(2, 3, 50, 32)
    with pytest.raises(ValueError, match="key bias"):
        port.small_attention(q, q, q, torch.zeros(bias_shape))


def _grads(fn, q, k, v, w):
    """Output and q/k/v gradients of sum(fn(q, k, v) * w) in JAX."""
    import jax

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("bias_kind", ["pad", "tome"])
@pytest.mark.parametrize("L", [50, 13])
def test_function_gradients_match_jax(L, bias_kind, monkeypatch):
    """The autograd Function (plain forward on the CPU, the JAX op's own
    backward) against ``jax.grad`` of the Pallas ``small_attention`` in
    interpret mode and of ``xla_attention_core``, at atol 3e-4 on the
    gradients (the bound of tests/test_flash_attention.py). An explicit key
    bias keeps the Pallas kernel's padding masked (see ROADMAP's reference
    defects for ``bias=None``)."""
    from jax.experimental import pallas as pl

    import antmmf_tpu.ops.pallas.small_attention as sa

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    q, k, v, bias = _inputs(L, bias_kind, seed=5)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = port.small_attention(tq, tk, tv, torch.from_numpy(bias))
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for fn in (lambda q, k, v: sa.small_attention(q, k, v, bias=jnp.asarray(bias)),
               lambda q, k, v: xla_attention_core(q, k, v, jnp.asarray(bias))):
        ref_out, ref_grads = _grads(fn, q, k, v, w)
        np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=ATOL)
        for t, g, name in zip((tq, tk, tv), ref_grads, "qkv"):
            np.testing.assert_allclose(t.grad.numpy(), g, atol=3e-4, err_msg=f"d{name}")


def test_backward_is_the_jax_formula_in_bf16():
    """In bf16 the backward computes in fp32 from the bf16 inputs and casts
    each gradient back, as the JAX ``_vjp_bwd`` does (atol 2e-2: one bf16
    rounding of each gradient)."""
    q, k, v, bias = _inputs(30, "pad", seed=7)
    w = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out = port.small_attention(*leaves, torch.from_numpy(bias))
    out.backward(torch.from_numpy(w).to(torch.bfloat16))
    ref = port.small_attention_backward(*(x.detach() for x in leaves),
                                        torch.from_numpy(bias)[:, 0, 0],
                                        torch.from_numpy(w).to(torch.bfloat16), 32 ** -0.5)
    for t, g in zip(leaves, ref):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.grad.float().numpy(), g.float().numpy())
    ref_out, ref_grads = _grads(
        lambda q, k, v: xla_attention_core(q, k, v, jnp.asarray(bias)),
        *(x.detach().float().numpy() for x in leaves),
        np.asarray(torch.from_numpy(w).to(torch.bfloat16).float()))
    for t, g in zip(leaves, ref_grads):
        np.testing.assert_allclose(t.grad.float().numpy(), g, atol=2e-2)
