"""The port's int8 serving and its quantiser on the model's device, against
the JAX package, on the CPU.

* ``quantize_params`` (``{"q", "scale", "dtype"}``) and
  ``quantize_for_decode(bits=8)`` (``{"q", "scale"}``) on the tiny Pink's
  params equal JAX's records byte for byte;
* ``quantize_module_for_decode``, the quantiser that works on the module's
  own tensors where they lie (here the CPU), leaves the module as
  ``load_decode_records`` of numpy's records leaves it: every buffer byte
  for byte and every parameter bit for bit, for int4 (group 32, so the
  64-row kernels pack) and int8 (``export_decode_records`` of the result
  loads into a twin to the same state), and for a 5504-row ``down_proj`` stored
  with 5632 rows at group 88, whose record is JAX's too;
* ``best_group``, the TPU tile search and ``pad_rows_for_kernel`` at the
  five kernel shapes of ``m2_omni_7b.yml``'s decoder equal JAX's (shapes
  only);
* int8 ``generate`` (decoder projections and ``lm_head`` held as int8
  buffers and dequantised at each call) gives JAX's int8 ``generate``'s
  tokens for Pink and M2-omni;
* JAX's ``load_quantized`` reads the port's ``save_quantized`` artifact
  and the port's reads JAX's, to the same arrays;
  ``scripts/quantize_checkpoint.py`` writes one from a ``params.npz``.
"""

import pickle

import numpy as np
import pytest
import torch

from antmmf_torch.common.build import build_config
from antmmf_torch.models.base_model import build_model
from antmmf_torch.models.m2_omni import M2Omni as TM
from antmmf_torch.models.pink import PinkModel as TPink
from antmmf_torch.modules.qdense import QuantDense
from antmmf_torch.ops import int4_matmul as t_int4
from antmmf_torch.predictors import quantization as t_quant
from antmmf_torch.scripts import quantize_checkpoint
from antmmf_torch.utils.weights import export_flax_params, flatten_flax, load_flax_params
from antmmf_tpu.models.m2_omni import M2Omni as JM
from antmmf_tpu.models.pink import PinkModel as JPink
from antmmf_tpu.ops.pallas import int4_matmul as j_int4
from antmmf_tpu.predictors import quantization as j_quant
from test_torch_generate_modes import M2, MAX_NEW, PINK, jbatch, m2_batch, pink_batch, tbatch
from test_torch_m2omni import load_reached
from test_torch_qwen2_vit import random_params
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

MIN_SIZE = 256
SHAPES_7B = {"q_o_proj": (4096, 4096), "k_v_proj": (4096, 1024), "gate_up_proj": (4096, 11008),
             "down_proj": (11008, 4096), "lm_head": (4096, 151936)}
PINK_CFG = "projects/pink/configs/pink_tiny.local.yml"


@pytest.fixture(scope="module")
def pink():
    jm = JPink(**PINK)
    params = random_params(jm, jbatch(pink_batch()), seed=31)
    return jm, params


def port_pink(params, **kw):
    model = TPink(**PINK, **kw, device="cpu").eval()
    load_flax_params(model, params)
    return model


def assert_records_equal(got, want):
    """Equal trees, records byte for byte; returns the number of int8
    records (an artifact record's ``q``, ``scale`` and ``dtype`` flatten to
    leaves of their own)."""
    flat, ref = flatten_flax(got), flatten_flax(want)
    assert set(flat) == set(ref)
    n = 0
    for path, rec in flat.items():
        if isinstance(rec, dict):
            assert set(rec) == set(ref[path]), path
            for k in rec:
                assert rec[k].dtype == np.asarray(ref[path][k]).dtype, path
                np.testing.assert_array_equal(rec[k], np.asarray(ref[path][k]), err_msg=path)
            n += "q" in rec
        else:
            assert rec.dtype == np.asarray(ref[path]).dtype, path
            np.testing.assert_array_equal(rec, np.asarray(ref[path]), err_msg=path)
            n += path.endswith("/q")
    return n


def test_int8_records_are_jax_bit_for_bit(pink):
    _, params = pink
    got, stats = t_quant.quantize_params(params, min_size=MIN_SIZE)
    want, want_stats = j_quant.quantize_params(params, min_size=MIN_SIZE)
    assert assert_records_equal(got, want) > 0 and stats == want_stats
    got = t_quant.quantize_for_decode({"params": params}, min_size=MIN_SIZE, bits=8)
    want = j_quant.quantize_for_decode({"params": params}, min_size=MIN_SIZE, bits=8)
    assert assert_records_equal(got, want) > 0
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        t_quant.quantize_for_decode({}, bits=3)


def module_state(model):
    """Every parameter and every QuantDense buffer, by name."""
    out = {n: p.detach() for n, p in model.named_parameters()}
    for name, mod in model.named_modules():
        if isinstance(mod, QuantDense):
            for k in ("kernel_q4", "kernel_q8", "kernel_scale"):
                if getattr(mod, k) is not None:
                    out[f"{name}.{k}"] = getattr(mod, k)
    return out


@pytest.mark.parametrize("bits", [4, 8])
def test_device_quantiser_leaves_the_module_as_numpy_records_do(pink, bits):
    _, params = pink
    on_device = port_pink(params)
    counts = t_quant.quantize_module_for_decode(on_device, bits=bits, min_size=MIN_SIZE,
                                                group=32)
    loaded = port_pink(params)
    records = t_quant.quantize_for_decode({"params": export_flax_params(loaded, stacked=False)},
                                          min_size=MIN_SIZE, bits=bits, group=32)
    assert t_quant.load_decode_records(loaded, records, torch.float32) == counts
    got, want = module_state(on_device), module_state(loaded)
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    # the serving module exported as records and loaded into a twin: the same state
    twin = port_pink(params)
    t_quant.load_decode_records(twin, t_quant.export_decode_records(on_device), torch.float32)
    for name, t in module_state(twin).items():
        assert torch.equal(got[name], t), name
    kind = "kernel_q4" if bits == 4 else "kernel_q8"
    assert getattr(on_device.decoder.layer_0.attention.q_proj, kind) is not None
    assert getattr(on_device.lm_head, kind) is not None
    # int4: each layer's down_proj (172 rows) takes an int8 record, served as int8
    assert on_device.decoder.layer_1.mlp.down_proj.kernel_q8 is not None
    assert counts[0] == 7 * 2 + 1


def test_device_quantiser_pads_a_down_proj_as_jax_does():
    rng = np.random.default_rng(6)
    w = (rng.normal(size=(5504, 256)) * 0.02).astype(np.float32)
    holder = torch.nn.Module()
    holder.decoder = torch.nn.Module()
    holder.decoder.layer_0 = torch.nn.Module()
    holder.decoder.layer_0.mlp = torch.nn.Module()
    holder.decoder.layer_0.mlp.down_proj = QuantDense(5504, 256, torch.float32)
    tree = {"decoder": {"layer_0": {"mlp": {"down_proj": {"kernel": w}}}}}
    load_flax_params(holder, tree)
    assert t_quant.quantize_module_for_decode(holder, bits=4, min_size=1024) == (1, 0)
    mod = holder.decoder.layer_0.mlp.down_proj
    want = j_quant.quantize_for_decode(tree, min_size=1024, bits=4)
    rec = want["decoder"]["layer_0"]["mlp"]["down_proj"]["kernel"]
    assert tuple(mod.kernel_q4.shape) == (2816, 256) and tuple(mod.kernel_scale.shape) == (64, 256)
    np.testing.assert_array_equal(mod.kernel_q4.numpy(), rec["q4"])
    np.testing.assert_array_equal(mod.kernel_scale.numpy(), rec["scale"])


@pytest.mark.parametrize("name", list(SHAPES_7B))
def test_tiling_decisions_at_the_7b_shapes_equal_jax(name):
    fin, fout = SHAPES_7B[name]
    g = t_int4.best_group(fin, fout)
    assert g == j_int4.best_group(fin, fout)
    assert t_int4._pick_tiles(fin, fout, g) == j_int4._pick_tiles(fin, fout, g)
    assert t_int4.pad_rows_for_kernel(fin, fout) == j_int4.pad_rows_for_kernel(fin, fout)


def test_pink_int8_generate_matches_jax(pink):
    jm, params = pink
    batch = pink_batch()
    records = j_quant.quantize_for_decode({"params": params}, min_size=MIN_SIZE, bits=8)
    want, _ = jm.generate(records, jbatch(batch), eos_id=1, max_length=MAX_NEW)
    model = port_pink(params)
    t_quant.quantize_module_for_decode(model, bits=8, min_size=MIN_SIZE)
    assert model.decoder.layer_1.mlp.down_proj.kernel_q8 is not None
    got, _ = model.generate(tbatch(batch), eos_id=1, max_length=MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_m2_int8_generate_matches_jax():
    batch = m2_batch()
    jm = JM(**M2)
    params = random_params(jm, jbatch(batch), seed=32)
    records = j_quant.quantize_for_decode({"params": params}, min_size=MIN_SIZE, bits=8)
    want, _ = jm.generate(records, jbatch(batch), eos_id=1, max_length=MAX_NEW)
    model = TM(**M2, device="cpu").eval()
    load_reached(model, params)
    t_quant.quantize_module_for_decode(model, bits=8, min_size=MIN_SIZE)
    assert model.lm_head.kernel_q8 is not None
    got, _ = model.generate(tbatch(batch), eos_id=1, max_length=MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_artifacts_load_in_both_packages(pink, tmp_path):
    _, params = pink
    variables = {"params": params}
    stats = t_quant.save_quantized(variables, str(tmp_path / "port.pkl"), min_size=MIN_SIZE)
    _, want_stats = j_quant.quantize_params(params, min_size=MIN_SIZE)
    assert stats == want_stats
    j_quant.save_quantized(variables, str(tmp_path / "jax.pkl"), min_size=MIN_SIZE)
    want = flatten_flax(j_quant.load_quantized(str(tmp_path / "jax.pkl"))["params"])
    for loaded in (j_quant.load_quantized(str(tmp_path / "port.pkl")),
                   t_quant.load_quantized(str(tmp_path / "jax.pkl"))):
        flat = flatten_flax(loaded["params"])
        assert set(flat) == set(want)
        for path in want:
            assert flat[path].dtype == want[path].dtype
            np.testing.assert_array_equal(flat[path], want[path], err_msg=path)
    with open(tmp_path / "port.pkl", "rb") as f:
        raw = pickle.load(f)
    assert raw["params"]["lm_head"]["kernel"]["q"].dtype == np.int8


def test_quantize_checkpoint_writes_the_artifact(tmp_path, capsys):
    shell = build_model(build_config(PINK_CFG), device="cpu")
    shell.init(seed=3)
    flat = flatten_flax(export_flax_params(shell.module))
    np.savez(tmp_path / "params.npz", **flat)
    summary = quantize_checkpoint.main(["--model_dir", str(tmp_path), "--config", PINK_CFG,
                                        "--out", str(tmp_path / "int8.pkl")])
    assert summary["quantized_kernels"] > 0 and summary["source"].endswith("params.npz")
    loaded = flatten_flax(j_quant.load_quantized(str(tmp_path / "int8.pkl"))["params"])
    want = flatten_flax(j_quant.dequantize_params(j_quant.quantize_params(
        export_flax_params(shell.module))[0]))
    assert set(loaded) == set(want) == set(flat)
    for path in want:
        np.testing.assert_array_equal(loaded[path], np.asarray(want[path]), err_msg=path)
