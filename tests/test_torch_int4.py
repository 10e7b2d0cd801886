"""The port's group-int4 decode ops against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages. Packed bytes,
scales, group choices and whole record trees must be equal bit for bit (the
record format is shared). Products are compared in fp32:

* ``plain_int4_gemv`` (what ``int4_gemv`` computes on the CPU, and what the
  CUDA kernel is held to on the card) against the Pallas GEMV in interpret
  mode on bf16-representable x: both accumulate exact products in fp32 and
  differ in summation order and in the TPU kernel's rank-1 ``-8·Σx``
  correction, so the bound is 1e-4 of the output's spread;
* against ``unpack_int4`` + matmul: scale-then-sum against sum-then-scale in
  fp32, the same 1e-4 (the JAX test of the kernel allows 2.5e-2 because its
  x is rounded to bf16);
* ``QuantDense`` and ``int4_apply`` against their JAX counterparts at
  atol 1e-4 on outputs of spread 1 to 50.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.modules.qdense import QuantDense as TQuantDense
from antmmf_torch.ops import int4_matmul as t_int4
from antmmf_torch.predictors import quantization as t_quant
from antmmf_torch.utils.weights import load_flax_params
from antmmf_tpu.modules.qdense import QuantDense as JQuantDense
from antmmf_tpu.ops.pallas import int4_matmul as j_int4
from antmmf_tpu.predictors import quantization as j_quant
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

REL = 1e-4
GEMV_SHAPES = [(2048, 512, 128), (2048, 2048, 128), (4096, 1024, 128), (2048, 2560, 64)]


def _packed(fin, fout, group, seed=0, std=1.0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(fin, fout)) * std).astype(np.float32)
    return rng, w, j_int4.pack_int4(w, group=group)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("fin,fout,group", GEMV_SHAPES + [(384, 64, 128), (256, 36, 32),
                                                           (5632, 256, 88)])
def test_pack_int4_is_bitwise_jax(fin, fout, group):
    _, w, (q4, scale) = _packed(fin, fout, group)
    p_q4, p_scale = t_int4.pack_int4(w, group=group)
    assert p_q4.dtype == np.uint8 and p_scale.dtype == np.float32
    np.testing.assert_array_equal(p_q4, q4)
    np.testing.assert_array_equal(p_scale, scale)
    back = t_int4.unpack_int4(*_t(q4, scale), torch.float32).numpy()
    ref = np.asarray(j_int4.unpack_int4(jnp.asarray(q4), jnp.asarray(scale), jnp.float32))
    np.testing.assert_array_equal(back, ref)


def test_pack_int4_refuses_unpackable():
    with pytest.raises(ValueError, match="not packable"):
        t_int4.pack_int4(np.zeros((100, 8), np.float32), group=128)


@pytest.mark.parametrize("fout", [128, 512, 1000, 2048])
def test_record_format_helpers_match_jax(fout):
    """Group choice, row padding and tile legality decide the record format;
    the port's copies agree with the JAX package over a grid of widths."""
    for fin in (64, 172, 256, 384, 768, 1024, 2048, 2752, 4096, 5504, 5632, 11008):
        for requested in (32, 64, 128):
            assert t_int4.best_group(fin, fout, requested) == \
                j_int4.best_group(fin, fout, requested), (fin, fout, requested)
            assert t_int4.pad_rows_for_kernel(fin, fout, requested) == \
                j_int4.pad_rows_for_kernel(fin, fout, requested), (fin, fout, requested)
            assert t_int4._pick_tiles(fin, fout, requested) == \
                j_int4._pick_tiles(fin, fout, requested)
            assert t_int4.packable((fin, fout), requested) == \
                j_int4.packable((fin, fout), requested)


def test_down_proj_pads_to_5632_rows_at_group_88():
    assert t_int4.pad_rows_for_kernel(5504, 2048) == 5632
    assert t_int4.best_group(5632, 2048) == 88


@pytest.mark.parametrize("fin,fout,group,rows", [
    *[pytest.param(*shape, 3, id="-".join(map(str, shape))) for shape in GEMV_SHAPES],
    # the row counts around the CUDA kernel's batches of x rows
    *[pytest.param(2048, 512, 128, rows, id=f"2048-512-128-rows{rows}") for rows in (1, 5, 31)],
])
def test_plain_gemv_matches_interpret_kernel_and_unpack_matmul(fin, fout, group, rows):
    rng, _, (q4, scale) = _packed(fin, fout, group)
    x = np.array(jnp.asarray(rng.normal(size=(rows, fin)), jnp.bfloat16).astype(jnp.float32))
    y = t_int4.int4_gemv(*_t(x, q4, scale)).numpy()
    assert y.dtype == np.float32 and y.shape == (rows, fout)
    kernel = np.asarray(j_int4.int4_gemv(jnp.asarray(x), jnp.asarray(q4), jnp.asarray(scale),
                                         interpret=True))
    dense = x @ np.asarray(j_int4.unpack_int4(jnp.asarray(q4), jnp.asarray(scale), jnp.float32))
    spread = np.abs(dense).std()
    assert np.abs(y - kernel).max() / spread < REL
    assert np.abs(y - dense).max() / spread < REL
    # the same x as bfloat16 is read as given: the same answer
    yb = t_int4.int4_gemv(torch.from_numpy(x).to(torch.bfloat16), *_t(q4, scale)).numpy()
    np.testing.assert_array_equal(yb, y)


@pytest.mark.parametrize("fin,fout,group,rows", [
    (384, 64, 128, 2),
    # outs that are multiples of 4 but not of the CUDA kernel's column tile,
    # and group 256 at in/2 = 1152 (the high half's groups start mid-group)
    (2048, 516, 128, 3), (2048, 2052, 128, 1), (2304, 256, 256, 5)])
def test_gemv_takes_a_group_that_does_not_divide_half(fin, fout, group, rows):
    """in=384 at group 128: the high half's scale rows start mid-group. The
    JAX kernel takes only outs that are multiples of 128, so these are held
    against JAX's ``unpack_int4`` + matmul."""
    rng, _, (q4, scale) = _packed(fin, fout, group, seed=4)
    x = rng.normal(size=(rows, fin)).astype(np.float32)
    y = t_int4.int4_gemv(*_t(x, q4, scale)).numpy()
    assert y.shape == (rows, fout)
    dense = x @ np.asarray(j_int4.unpack_int4(jnp.asarray(q4), jnp.asarray(scale), jnp.float32))
    assert np.abs(y - dense).max() / np.abs(dense).std() < REL


@pytest.mark.parametrize("rows,route", [(1, "gemv"), (32, "gemv"), (33, "matmul"),
                                        (113, "matmul")])
def test_int4_apply_routes_by_rows_and_matches_jax(rows, route, monkeypatch):
    rng, _, (q4, scale) = _packed(512, 256, 64, seed=5)
    x = rng.normal(size=(1, rows, 512)).astype(np.float32)
    calls = []
    real = t_int4.int4_gemv
    monkeypatch.setattr(t_int4, "int4_gemv", lambda *a: calls.append(a[0].shape) or real(*a))
    y = t_int4.int4_apply(*_t(x, q4, scale), torch.float32)
    assert y.shape == (1, rows, 256) and y.dtype == torch.float32
    assert calls == ([torch.Size([rows, 512])] if route == "gemv" else [])
    ref = np.asarray(j_int4.int4_apply(jnp.asarray(x), jnp.asarray(q4), jnp.asarray(scale),
                                       jnp.float32))
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("rows", [2, 40])
def test_row_padded_record_takes_unpadded_x(rows):
    """A 5504-row down_proj is stored with 5632 rows at group 88; x keeps its
    5504 columns on both routes."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(5504, 256)) * 0.02).astype(np.float32)
    tree = {"decoder": {"layer_0": {"mlp": {"down_proj": {"kernel": w}}}}}
    rec = t_quant.quantize_for_decode(tree, min_size=1024)["decoder"]["layer_0"]["mlp"][
        "down_proj"]["kernel"]
    assert rec["q4"].shape == (2816, 256) and rec["scale"].shape == (64, 256)
    x = rng.normal(size=(rows, 5504)).astype(np.float32)
    y = t_int4.int4_apply(*_t(x, rec["q4"], rec["scale"]), torch.float32).numpy()
    ref = np.asarray(j_int4.int4_apply(jnp.asarray(x), jnp.asarray(rec["q4"]),
                                       jnp.asarray(rec["scale"]), jnp.float32))
    np.testing.assert_allclose(y, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["33_rows", "float64_x", "int8_packed", "x_too_wide",
                                  "scale_width", "scale_rows", "x_3d"])
def test_gemv_refuses_what_the_kernel_does_not_take(case):
    x, q4, scale = torch.zeros(2, 256), torch.zeros(128, 16, dtype=torch.uint8), \
        torch.ones(2, 16)
    if case == "33_rows":
        x = torch.zeros(33, 256)
    elif case == "float64_x":
        x = x.double()
    elif case == "int8_packed":
        q4 = q4.to(torch.int8)
    elif case == "x_too_wide":
        x = torch.zeros(2, 258)
    elif case == "scale_width":
        scale = torch.ones(2, 8)
    elif case == "scale_rows":
        scale = torch.ones(3, 16)
    elif case == "x_3d":
        x = torch.zeros(1, 2, 256)
    with pytest.raises(ValueError, match="int4_gemv"):
        t_int4.int4_gemv(x, q4, scale)


def test_quantize_for_decode_down_proj_leaf_is_bitwise_jax():
    rng = np.random.default_rng(6)
    w = (rng.normal(size=(5504, 2048)) * 0.02).astype(np.float32)
    tree = {"params": {"decoder": {"layer_3": {"mlp": {"down_proj": {"kernel": w}}}}}}
    port = t_quant.quantize_for_decode(tree)
    ref = j_quant.quantize_for_decode(tree, bits=4)
    p = port["params"]["decoder"]["layer_3"]["mlp"]["down_proj"]["kernel"]
    r = ref["params"]["decoder"]["layer_3"]["mlp"]["down_proj"]["kernel"]
    assert set(p) == set(r) == {"q4", "scale"}
    assert p["q4"].shape == (2816, 2048) and p["scale"].shape == (64, 2048)
    np.testing.assert_array_equal(p["q4"], r["q4"])
    np.testing.assert_array_equal(p["scale"], r["scale"])
    # the same kernel off the QuantDense paths keeps its rows (group 128, 43 scale rows)
    loose = t_quant.quantize_for_decode({"mlp": {"down_proj": {"kernel": w}}})
    assert loose["mlp"]["down_proj"]["kernel"]["q4"].shape == (2752, 2048)
    assert loose["mlp"]["down_proj"]["kernel"]["scale"].shape == (43, 2048)


def test_quantize_for_decode_int8_is_not_ported():
    """The name is kept from when int8 was refused. It checks that the int8
    record of a kernel is JAX's byte for byte, and that a width other than 4
    or 8 bits is refused as JAX refuses it."""
    w = (np.random.default_rng(8).normal(size=(512, 256)) * 0.02).astype(np.float32)
    tree = {"mlp": {"down_proj": {"kernel": w}}}
    port = t_quant.quantize_for_decode(tree, bits=8)["mlp"]["down_proj"]["kernel"]
    ref = j_quant.quantize_for_decode(tree, bits=8)["mlp"]["down_proj"]["kernel"]
    assert set(port) == set(ref) == {"q", "scale"}
    for k in ("q", "scale"):
        assert port[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(port[k], ref[k])
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        t_quant.quantize_for_decode({}, bits=3)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        j_quant.quantize_for_decode({}, bits=3)


@pytest.mark.parametrize("rows", [3, 40])
def test_quant_dense_float_and_packed_match_jax(rows):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(rows, 256)).astype(np.float32)
    kernel = (rng.normal(size=(256, 96)) * 0.1).astype(np.float32)
    jm = JQuantDense(96, dtype=jnp.float32)
    port = TQuantDense(256, 96, torch.float32)
    load_flax_params(port, {"kernel": kernel})
    ref = np.asarray(jm.apply({"params": {"kernel": kernel}}, jnp.asarray(x)))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), ref, atol=1e-5,
                               rtol=0)
    q4, scale = j_int4.pack_int4(kernel, group=64)
    ref = np.asarray(jm.apply({"params": {"kernel_q4": q4, "kernel_scale": scale}},
                              jnp.asarray(x)))
    port.load_packed(q4, scale)
    assert port.weight is None and not list(port.parameters())
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), ref, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="does not fit"):
        port.load_packed(q4[:, :8], scale)


def test_quant_dense_freeze_stops_the_weight_gradient_only():
    port = TQuantDense(8, 4, torch.float32, freeze=True)
    x = torch.ones(2, 8, requires_grad=True)
    port(x).sum().backward()
    assert port.weight.grad is None and x.grad is not None
