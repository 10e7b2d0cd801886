"""The port's ring and Ulysses attention against the JAX package, on the CPU.

One spawn of 2 gloo ranks (``antmmf_torch.utils.launch`` running
``torch_sp_worker.py``) holds every case, ``{seq: 2}``: each rank pads
the whole q, k, v [2, H, 13, 32] (fp32, drawn with numpy) to the axis,
takes its slice, runs ``parallel.long_context`` and gathers the output;
the q/k/v gradients of ⟨out, dout⟩ come back as the train step reduces
them, the mean over the ranks. The references, computed in this process
while the ranks run: the ``seq`` collectives' outputs and gradients
(their transposes) computed by hand, JAX's ``ring_attention`` /
``ulysses_attention`` on a ``{seq: 2}`` mesh of the virtual CPU devices,
forward and ``jax.vjp``
(one compile a case), and JAX's dense ``xla_attention_core`` with the
causal and key-padding biases.

Cases: the ring causal and not, with GQA (4 query heads on 2 kv heads),
the plain ring step (JAX's einsum) and the flash route (``blocks``
``flash``: on CPU tensors the flash kernels' plain versions, merged by
their row statistics as on the card); Ulysses causal (K/V expanded to the
query heads, as JAX's callers do) and not, with 3 heads, zero-padded to
the axis. L is 13 (odd: the stream pads to 14 with a masked key) and
sample 1's last 4 keys are masked. Tolerances (fp32, sums in another
order): the output at atol 2e-5 (JAX's own SP tests' bound), the
gradients at atol 5e-5.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.utils.launch import launch
from antmmf_tpu.modules.attention import xla_attention_core
from antmmf_tpu.parallel.long_context import ring_attention, ulysses_attention
from antmmf_tpu.parallel.mesh import build_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
B, L, D = 2, 13, 32
OUT_ATOL, GRAD_ATOL = 2e-5, 5e-5
CASES = {
    "ring_causal_gqa": dict(mode="ring", causal=True, heads=(4, 2), blocks="plain"),
    "ring_gqa": dict(mode="ring", causal=False, heads=(4, 2), blocks="plain"),
    "ring_causal_gqa_flash_route": dict(mode="ring", causal=True, heads=(4, 2), blocks="flash"),
    "ring_gqa_flash_route": dict(mode="ring", causal=False, heads=(4, 2), blocks="flash"),
    "ulysses_causal_expanded_gqa": dict(mode="ulysses", causal=True, heads=(4, 4)),
    "ulysses_odd_heads": dict(mode="ulysses", causal=False, heads=(3, 3)),
}


def case_arrays(name, seed):
    c = CASES[name]
    rng = np.random.default_rng(seed)
    H, Hkv = c["heads"]
    q = rng.standard_normal((B, H, L, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, L, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, L, D)).astype(np.float32)
    if c["mode"] == "ulysses" and name.endswith("gqa"):  # from 2 kv heads, expanded
        k, v = (np.repeat(t[:, :2], 2, axis=1) for t in (k, v))
    mask = np.ones((B, L), np.int64)
    mask[1, -4:] = 0
    dout = rng.standard_normal((B, H, L, D)).astype(np.float32)
    return dict(c, q=q, k=k, v=v, mask=mask, dout=dout)


ARRAYS = {name: case_arrays(name, seed) for seed, name in enumerate(CASES)}
_rng = np.random.default_rng(9)
COLLECTIVES = {"x": _rng.standard_normal((2, 4)).astype(np.float32),
               "w": _rng.standard_normal((4, 4)).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawn starts first and runs while the JAX references compile."""
    tmp = str(tmp_path_factory.mktemp("sp_attention"))
    spec, out = os.path.join(tmp, "spec.pt"), os.path.join(tmp, "out")
    os.makedirs(out)
    torch.save({"scenarios": [("collectives", "collectives", COLLECTIVES),
                              ("attention", "attention",
                               {"cases": [ARRAYS[n] for n in CASES]})]}, spec)

    def run():
        code = launch([os.path.join(HERE, "torch_sp_worker.py"), spec, out], nproc=2,
                      poll_seconds=0.2, extra_env={"OMP_NUM_THREADS": "1"})
        assert code == 0
        results = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                   for r in range(2)]
        return dict(zip(CASES, results[0]["attention"])), results

    return concurrent.futures.ThreadPoolExecutor(1).submit(run)


def bias_of(a):
    return jnp.asarray(np.where(a["mask"] > 0, 0.0, -1e30)[:, None, None, :], jnp.float32)


def jax_sp(a):
    """JAX's function on a {seq: 2} mesh: output and the q/k/v cotangents."""
    mesh = build_mesh({"seq": 2}, devices=jax.devices()[:2])
    fn = ring_attention if a["mode"] == "ring" else ulysses_attention
    f = jax.jit(lambda q, k, v: fn(q, k, v, mesh, bias=bias_of(a), causal=a["causal"]))
    out, vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in "qkv"))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in vjp(jnp.asarray(a["dout"])))


def jax_dense(a):
    rep = a["q"].shape[1] // a["k"].shape[1]
    k, v = (jnp.repeat(jnp.asarray(a[n]), rep, axis=1) for n in "kv")
    bias = bias_of(a)
    if a["causal"]:
        bias = bias + jnp.where(jnp.arange(L)[None, :] > jnp.arange(L)[:, None], -1e30, 0.0)
    return np.asarray(xla_attention_core(jnp.asarray(a["q"]), k, v, bias=bias))


@pytest.fixture(scope="module")
def references(ranks):
    return {name: (jax_sp(a), jax_dense(a)) for name, a in ARRAYS.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_sp_attention_matches_jax(ranks, references, name):
    got = ranks.result()[0][name]
    (out, dq, dk, dv), dense = references[name]
    np.testing.assert_allclose(got["out"], out, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(got["out"], dense, atol=OUT_ATOL, rtol=0)
    for n, ref in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[n], ref, atol=GRAD_ATOL, rtol=0, err_msg=n)


def test_seq_collectives_and_their_transposes(ranks):
    """Rank r holds row r of x [2, 4]; each collective's output and the
    gradient of Σ_r ⟨y_r, w + r⟩ (w cut to y's shape) with respect to x_r:
    ppermute sends row r to rank r+1 (its backward the reverse shift);
    the tiled all-to-all over dim 1 → 0 gives rank r the r-th half of
    every row (backward: the reverse exchange); the gather gives every
    rank both rows (backward: the sum over ranks of the cotangent of its
    row, the reduce-scatter); the all-reduce the sum of the rows
    (backward: the sum of the cotangents)."""
    r0, r1 = (r["collectives"] for r in ranks.result()[1])
    x, w = COLLECTIVES["x"], COLLECTIVES["w"]
    assert r0["axis"] == (0, 2) and r1["axis"] == (1, 2)
    for r, got in enumerate((r0, r1)):
        o = 1 - r  # the other rank
        np.testing.assert_array_equal(got["ppermute"]["y"], x[o:o + 1])
        # x_r went to rank o, whose loss weighs it by w[:1] + o
        np.testing.assert_allclose(got["ppermute"]["grad"], w[:1] + o, rtol=1e-6)
        np.testing.assert_array_equal(got["all_to_all"]["y"], x[:, 2 * r:2 * r + 2])
        # x_r's half h went to rank h, weighed there by w[r, :2] + h
        want = np.concatenate([w[r:r + 1, :2] + h for h in range(2)], 1)
        np.testing.assert_allclose(got["all_to_all"]["grad"], want, rtol=1e-6)
        np.testing.assert_array_equal(got["all_gather_seq"]["y"], x)
        np.testing.assert_allclose(got["all_gather_seq"]["grad"], 2 * w[r:r + 1] + 1,
                                   rtol=1e-6)
        np.testing.assert_allclose(got["all_reduce_sum"]["y"], x.sum(0, keepdims=True),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["all_reduce_sum"]["grad"], 2 * w[:1] + 1, rtol=1e-6)


def test_both_ranks_hold_the_whole_output(ranks):
    r0, r1 = ranks.result()[1]
    for a, b in zip(r0["attention"], r1["attention"]):
        np.testing.assert_array_equal(a["out"], b["out"])
        np.testing.assert_array_equal(a["dq"], b["dq"])
