"""The port's flash attention (antmmf_torch/ops/flash_attention.py) against the
JAX package, on the CPU.

The CUDA kernels run only on a card (chip_smoke.py holds them against their
plain versions there). Here the autograd Function takes the plain versions,
the kernels' algorithm in plain PyTorch (forward with saved row statistics,
dQ and dK/dV recomputed from them), and is held against the Pallas
``flash_attention`` in interpret mode and against ``xla_attention_core``,
forward and q/k/v gradients, with Lq ≠ Lk, causal masking and fully masked
rows. Inputs are drawn with numpy. Tolerance: atol 2e-5 on the output and
3e-4 on the gradients in fp32, the bounds of tests/test_flash_attention.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.modules import attention as t_attention
from antmmf_torch.ops import flash_attention as port
from antmmf_tpu.modules.attention import xla_attention_core
from antmmf_tpu.ops.pallas.flash_attention import flash_attention as j_flash

ATOL, GRAD_ATOL = 2e-5, 3e-4
B, H, D = 2, 2, 32
FMIN = np.finfo(np.float32).min


def _inputs(Lq, Lk, seed, masked_sample=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Lq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, Lk, D)).astype(np.float32) for _ in range(2))
    lens = np.array([Lk, max(1, Lk - 7)])
    bias = np.where(np.arange(Lk)[None] < lens[:, None], 0.0, FMIN).astype(np.float32)
    if masked_sample:
        bias[0] = FMIN  # every key of sample 0 masked
    w = rng.standard_normal((B, H, Lq, D)).astype(np.float32)  # cotangent weights
    return q, k, v, bias, w


def _port(q, k, v, bias, w, causal, bias_rank=2):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias if bias_rank == 2
                                                    else bias[:, None, None, :])
    out = port.flash_attention(tq, tk, tv, tb, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _jax(fn, q, k, v, w):
    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, ref):
    np.testing.assert_allclose(got[0], ref[0], atol=ATOL, rtol=0, err_msg="out")
    for a, b, name in zip(got[1], ref[1], "qkv"):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("Lq,Lk,causal", [(24, 70, False), (70, 70, True), (50, 30, True)])
def test_matches_pallas_interpret(Lq, Lk, causal):
    q, k, v, bias, w = _inputs(Lq, Lk, seed=Lq + Lk)
    ref = _jax(lambda q, k, v: j_flash(q, k, v, bias=jnp.asarray(bias), causal=causal,
                                       interpret=True, block_q=32, block_k=32), q, k, v, w)
    _close(_port(q, k, v, bias, w, causal), ref)


@pytest.mark.parametrize("Lq,Lk,causal,bias_rank", [
    (40, 40, False, None), (24, 70, False, 2), (70, 30, False, 4), (70, 70, True, 4),
    (50, 30, True, None), (30, 50, True, 2)])
def test_matches_xla_core(Lq, Lk, causal, bias_rank):
    q, k, v, bias, w = _inputs(Lq, Lk, seed=3 * Lq + Lk)
    mask = np.zeros((1, 1, Lq, Lk), np.float32)
    if causal:
        mask = np.where(np.tril(np.ones((Lq, Lk), bool)), 0.0, -np.inf)[None, None]
    full = mask if bias_rank is None else mask + bias[:, None, None, :]
    ref = _jax(lambda q, k, v: xla_attention_core(q, k, v, bias=jnp.asarray(full)), q, k, v, w)
    _close(_port(q, k, v, None if bias_rank is None else bias, w, causal, bias_rank or 2), ref)


@pytest.mark.parametrize("Lk", [40, 64])
def test_fully_masked_row_is_uniform_average(Lk):
    """A sample whose keys all carry finfo.min attends uniformly, as in
    ``xla_attention_core``, forward and backward. (The Pallas kernel returns
    0 for such rows: its running max starts at -1e30, above finfo.min.)"""
    q, k, v, bias, w = _inputs(24, Lk, seed=Lk, masked_sample=True)
    got = _port(q, k, v, bias, w, False)
    assert np.isfinite(got[0]).all() and all(np.isfinite(g).all() for g in got[1])
    np.testing.assert_allclose(got[0][0], np.broadcast_to(v[0].mean(1, keepdims=True),
                                                          (H, 24, D)), atol=ATOL)
    ref = _jax(lambda q, k, v: xla_attention_core(q, k, v, bias=jnp.asarray(bias)[:, None, None]),
               q, k, v, w)
    _close(got, ref)


def test_plain_versions_match_plain_autograd_in_bf16():
    """The kernels' plain versions, run step by step in bf16, against autograd
    of ``plain_flash_attention``: the forward rounds P before P·V without
    normalising and dS before dS·K, so they agree to bf16 rounding (atol 0.05
    at this scale)."""
    q, k, v, bias, w = _inputs(70, 90, seed=11)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    kb, dout = torch.from_numpy(bias), torch.from_numpy(w).to(torch.bfloat16)
    out, stats = port.plain_flash_fwd(*bf, kb, D ** -0.5, True)
    dq, delta = port.plain_flash_dq(*bf, kb, out, stats, dout, D ** -0.5, True)
    dk, dv = port.plain_flash_dkv(*bf, kb, stats, dout, delta, D ** -0.5, True)
    leaves = [x.clone().requires_grad_() for x in bf]
    ref = port.plain_flash_attention(*leaves, kb, causal=True)
    ref.backward(dout)
    for a, b in zip((out, dq, dk, dv), (ref, *(x.grad for x in leaves))):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.detach().float().numpy(), atol=5e-2)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    before = (port.flash_fwd.launches, port.flash_dq.launches, port.flash_dkv.launches)
    _port(*_inputs(30, 20, seed=5), False)
    assert (port.flash_fwd.launches, port.flash_dq.launches,
            port.flash_dkv.launches) == before


def test_non_cpu_tensors_never_fall_back():
    q = torch.empty(2, 3, 300, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.flash_attention(q, q, q)


@pytest.mark.parametrize("shape_q,shape_k,bias_shape,dtype", [
    ((2, 3, 50, 48), (2, 3, 50, 48), None, torch.float32),
    ((2, 3, 50, 64), (2, 3, 50, 64), None, torch.float16),
    ((2, 3, 50, 64), (2, 2, 50, 64), None, torch.float32),
    ((2, 3, 50, 64), (2, 3, 60, 64), (2, 50), torch.float32),
    ((2, 3, 50, 64), (2, 3, 60, 64), (2, 3, 1, 60), torch.float32),
    ((2, 3, 50, 64), (2, 3, 60, 64), (2, 1, 50, 60), torch.float32),
])
def test_contract_refusals(shape_q, shape_k, bias_shape, dtype):
    q, k = torch.zeros(shape_q, dtype=dtype), torch.zeros(shape_k, dtype=dtype)
    bias = None if bias_shape is None else torch.zeros(bias_shape)
    with pytest.raises(ValueError, match="flash_attention takes"):
        port.flash_attention(q, k, k, bias)


@pytest.mark.parametrize("Lq,Lk,route", [(50, 50, "small"), (256, 256, "small"),
                                         (257, 257, "flash"), (30, 40, "flash")])
def test_attention_core_routes_by_structure(Lq, Lk, route, monkeypatch):
    calls = []
    for name in ("small_attention", "flash_attention"):
        real = getattr(t_attention, name)
        monkeypatch.setattr(t_attention, name,
                            lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a, **kw))
    q, k = torch.zeros(1, 2, Lq, 32), torch.zeros(1, 2, Lk, 32)
    t_attention.attention_core(q, k, k, torch.zeros(1, 1, 1, Lk))
    assert calls == [f"{route}_attention"]
