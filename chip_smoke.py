"""Drive the antmmf_torch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py              # from the repository root, on a machine with CUDA
    python3 chip_smoke.py --calibrate  # the card-vs-CPU readings: seeds and planted faults

Phases, each printing JSON lines; a failing phase ends the script with a
non-zero code and no result line:

1. card and build: the GPU's name and power limit (``nvidia-smi``), the
   kernels built from ``antmmf_torch/ops/csrc`` with ``nvcc``; TF32 is turned
   off so fp32 checks are exact;
2. kernel vs plain: ``small_attention`` against ``plain_small_attention`` on
   the same inputs at the serving path's shapes, bf16 and fp32, and its
   autograd Function's gradients against fp32 autograd of the plain version;
   ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` against their plain versions
   on the same inputs (the cross-encoder's [64, 12, 430, 64] with ragged key
   masks, Lq ≠ Lk, causal, a fully masked row, D 32 and 128), and the
   ``flash_attention`` Function against fp32 autograd of
   ``plain_flash_attention``;
3. serving: ``projects/base_vtp/configs/serving.yml`` at full width (ViT-B/32
   at 8x224², BERT-base at L=30, bf16, seeded random weights) through the
   port's CLI and predictor code: one ``predict`` and one ``predict_batch`` of
   8, at ``token_merge_r`` 8 (as shipped) and 0; every forward must launch the
   attention kernel 24 times (12 ViT + 12 BERT layers);
4. card vs CPU (serving): the same weights in fp32 on the CPU (plain
   versions) against bf16 on the card, r=0, one request, held to the bound
   that ``--calibrate`` reads from sound seeds and planted faults;
5. training: ``bench.py``'s two training legs at full width through
   ``build_model``, ``build_optimizer``, ``TrainState`` and
   ``make_train_step`` (AdamW lr 5e-5, weight decay 0.01, bf16 first moment,
   clip 1.0), repeating one fixed batch: the flagship (B=32) and the
   cross-mined step (B=16, cross-encoder of 2 layers, ``hard_mining_k`` 4, so
   64 pairs of 430 tokens). Per step: the loss (finite and falling), the
   time, the kernels' launches (24 of ``small_attention``; for the
   cross-mined step 2 of each flash kernel); the step time p50, clip-text
   pairs/s and the device's idle share from ``torch.profiler``;
6. card vs CPU (training): the cross-mined step at B=4 on the same fp32
   master weights, bf16 on the card against fp32 on the CPU: the first
   step's loss and each parameter's gradient cosine, held to the bound that
   ``--calibrate`` reads;
7. times: text-query and full-encode latency, each kernel's time beside its
   bound, its plain version and the library call at the path's shapes, with
   the GPU's name and power limit;
8. trace: ``torch.profiler`` over full encodes at B=32: device-busy time per
   forward against the untraced wall time (the device's idle share), device
   operations (kernels and copies) per forward and those that take the most
   device time.

Each path (serving, each training leg) runs with the kernels' launch counts
set to 0 just before it and read just after; launches made to compare a
kernel with its plain version or to time it are not counted. The line
before the last holds the kernel table, the last line the result. Without
CUDA the script exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")

import torch.nn.functional as F  # noqa: E402

from antmmf_torch.models.base_model import build_model  # noqa: E402
from antmmf_torch.modules.layers import make_attention_mask  # noqa: E402
from antmmf_torch.ops import _build  # noqa: E402
from antmmf_torch.ops import flash_attention as fa  # noqa: E402
from antmmf_torch.ops import small_attention as sa  # noqa: E402
from antmmf_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_dkv,
    flash_dq,
    flash_fwd,
    plain_flash_attention,
    plain_flash_dkv,
    plain_flash_dq,
    plain_flash_fwd,
)
from antmmf_torch.ops.small_attention import (  # noqa: E402
    key_bias,
    plain_small_attention,
    small_attention,
)
from antmmf_torch.optimizer.build import build_optimizer  # noqa: E402
from antmmf_torch.predictors.cli import build_predictor  # noqa: E402
from antmmf_torch.trainers.train_state import TrainState, make_train_step  # noqa: E402
from antmmf_torch.utils.weights import flax_paths  # noqa: E402

CONFIG = "projects/base_vtp/configs/serving.yml"
FRAMES, SIZE, SEED = 8, 224, 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores (data sheet)
FP32_TOL = 1e-5             # fp32: only summation order differs
BF16_ULPS = 3               # bf16: P and the output round once each
# card bf16 vs CPU fp32 at full width (``--calibrate`` reads the gap): sound
# runs over five seeds stay above cos 0.99989 and below |Δsim| 0.0071; BERT's
# key bias dropped reads text cos 0.744 and |Δsim| 0.076 (H100 readings)
COS_MIN, DSIM_MAX = 0.999, 0.05
# flash kernels vs their plain versions on the same inputs, in bf16 ulps of
# the reference's largest magnitude; against fp32 autograd of the plain
# semantics (the kernels round P and dS to bf16 first), twice that
FLASH_ULPS, FLASH_AUTOGRAD_ULPS = 2, 4
# card bf16 vs CPU fp32, first cross-mined training step at B=4: the cosine
# of all gradients together, the least per-parameter cosine, |Δloss|
GRAD_COS_ALL, GRAD_COS_MIN, DLOSS_MAX = 0.99, 0.9, 0.01

TEXT_LEN = 30
VIT_TOKENS = (SIZE // 32) ** 2 + 1  # ViT-B/32 tokens per frame, the class token included
TRAIN_STEPS, TRAIN_WARMUP = 6, 2
CROSS = dict(with_cross_encoder=True, cross_layers=2, hard_mining_k=4)
TRAIN_LEGS = {"flagship": ({}, 32), "cross_mined": (CROSS, 16)}
# launches per training step: 12 ViT + 12 BERT layers forward (K1's
# backward is plain tensor ops, as in the JAX package); the cross-encoder's
# two layers run the flash forward, dQ and dK/dV once each
STEP_LAUNCHES = {
    "flagship": {"small_attention": 24, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "cross_mined": {"small_attention": 24, "flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2},
}
KERNELS = (small_attention, flash_fwd, flash_dq, flash_dkv)


def zero_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def read_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[0].strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ phase 2
def kernel_cases(gen):
    """(name, q, k, v, bias) at the serving path's shapes, one dtype at a time."""
    dev = "cuda"
    fmin = torch.finfo(torch.float32).min

    def qkv(B, H, L, D, dtype, strided=False):
        if strided:  # the [B, L, H, D] projection layout MultiHeadAttention passes
            t = [torch.randn(B, L, H, D, generator=gen, device=dev).to(dtype).transpose(1, 2)
                 for _ in range(3)]
        else:
            t = [torch.randn(B, H, L, D, generator=gen, device=dev).to(dtype) for _ in range(3)]
        return t

    def pad_bias(B, L, lo):
        lens = torch.randint(lo, L + 1, (B,), generator=gen, device=dev)
        return make_attention_mask((torch.arange(L, device=dev)[None] < lens[:, None]).long())

    def tome_bias(B, L):
        size = torch.randint(1, 9, (B, L), generator=gen, device=dev).float()
        return torch.log(size)[:, None, None, :]

    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        yield (f"vit_L50_{tag}", *qkv(256, 12, 50, 64, dtype, strided=True), None)
        yield (f"bert_L30_pad_{tag}", *qkv(32, 12, 30, 64, dtype, strided=True),
               pad_bias(32, 30, 5))
        for L in (42, 34, 26, 18, 10, 6, 4, 3, 2):
            yield (f"tome_L{L}_{tag}", *qkv(64, 12, L, 64, dtype), tome_bias(64, L))
        yield f"d32_L50_pad_{tag}", *qkv(64, 8, 50, 32, dtype), pad_bias(64, 50, 1)
        yield f"d128_L50_{tag}", *qkv(64, 6, 50, 128, dtype), None
        yield f"L256_pad_{tag}", *qkv(8, 12, 256, 64, dtype), pad_bias(8, 256, 1)
        q, k, v = qkv(2, 3, 50, 64, dtype)
        masked = torch.zeros(2, 1, 1, 50, device=dev)
        masked[0] = fmin  # every key of sample 0 masked
        yield f"fully_masked_{tag}", q, k, v, masked


def phase_kernels() -> float:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst_main = 0.0
    failed = []
    for name, q, k, v, bias in kernel_cases(gen):
        out = small_attention(q, k, v, bias=bias)
        ref = plain_small_attention(q, k, v, bias=bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = (FP32_TOL if q.dtype == torch.float32
               else BF16_ULPS * torch.finfo(torch.bfloat16).eps * max(scale, 1.0))
        ok = bool(torch.isfinite(out).all().item()) and err <= tol
        if name.startswith("fully_masked"):
            uniform = v[0].float().mean(dim=1, keepdim=True).expand(-1, 50, -1)
            uerr = (out[0].float() - uniform).abs().max().item()
            ok = ok and uerr <= tol
        emit(phase="kernel_check", case=name, shape=list(q.shape), dtype=str(q.dtype),
             max_abs_err=err, tol=tol, ok=ok)
        if name == "vit_L50_bf16":
            worst_main = err
        if not ok:
            failed.append(name)
    check(not failed, f"kernel disagrees with its plain version: {failed}")
    # a head whose K and V overflow shared memory is refused by the CUDA
    # entry point and raised by the wrapper, never computed another way
    big = torch.zeros(1, 1, 256, 128, device="cuda")
    try:
        small_attention(big, big, big)
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    emit(phase="kernel_check", case="fp32_d128_L256_refused", refusal=refusal)
    check(refusal is not None and "CUDA error" in refusal,
          "an oversize head was not refused by the kernel")
    # the autograd Function: a grad_fn on the card, gradients as fp32
    # autograd of the plain version on the same bf16 values
    q, k, v = (t.detach().requires_grad_() for t in next(kernel_cases(gen))[1:4])
    out = small_attention(q, k, v)
    check(out.grad_fn is not None, "small_attention's output has no grad_fn on the card")
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out.backward(dout)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    plain_small_attention(*leaves).backward(dout.float())
    errs = grad_errs((q, k, v), leaves, "qkv")
    ok = all(e <= tol for e, tol in errs.values())
    emit(phase="kernel_check", case="vit_L50_bf16_autograd", grad_fn=out.grad_fn.name(),
         max_abs_err={n: e for n, (e, _) in errs.items()},
         tol={n: t for n, (_, t) in errs.items()}, ok=ok)
    check(ok, "small_attention's gradients disagree with fp32 autograd")
    return worst_main


def ulps_tol(ref: torch.Tensor, ulps: float) -> float:
    """``ulps`` bf16 roundings at the reference's largest magnitude (≥ 1)."""
    return ulps * torch.finfo(torch.bfloat16).eps * max(ref.float().abs().max().item(), 1.0)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def grad_errs(got, ref, names, ulps=BF16_ULPS):
    """{d<name>: (max error, tolerance)} of ``got``'s grads against ``ref``'s."""
    return {f"d{n}": (max_err(a.grad, b.grad), ulps_tol(b.grad, ulps))
            for a, b, n in zip(got, ref, names)}


# ------------------------------------------------------ phase 2: flash kernels
def flash_cases(gen):
    """(name, q, k, v, key bias [B, 1, 1, Lk] or None, causal); q/k/v in the
    [B, L, H, D] projection layout seen as [B, H, L, D], as on the path."""
    dev, fmin = "cuda", torch.finfo(torch.float32).min

    def proj(B, L, H, D):
        return torch.randn(B, L, H, D, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)

    def ragged(B, L, lo):
        lens = torch.randint(lo, L + 1, (B,), generator=gen, device=dev)
        return make_attention_mask((torch.arange(L, device=dev)[None] < lens[:, None]).long())

    yield "cross_L430_ragged", proj(64, 430, 12, 64), proj(64, 430, 12, 64), \
        proj(64, 430, 12, 64), ragged(64, 430, 30), False
    yield "lq120_lk430_ragged", proj(8, 120, 12, 64), proj(8, 430, 12, 64), \
        proj(8, 430, 12, 64), ragged(8, 430, 100), False
    yield "causal_L430", proj(8, 430, 12, 64), proj(8, 430, 12, 64), proj(8, 430, 12, 64), \
        None, True
    masked = ragged(4, 300, 1)
    masked[0] = fmin  # every key of sample 0 masked
    yield "fully_masked_L300", proj(4, 300, 12, 64), proj(4, 300, 12, 64), \
        proj(4, 300, 12, 64), masked, False
    yield "d32_lq70_lk290", proj(4, 70, 8, 32), proj(4, 290, 8, 32), proj(4, 290, 8, 32), \
        ragged(4, 290, 1), False
    yield "d128_L270_causal", proj(4, 270, 6, 128), proj(4, 270, 6, 128), \
        proj(4, 270, 6, 128), ragged(4, 270, 1), True


def phase_flash() -> dict:
    """Each flash kernel against its plain version on the same inputs, and
    the autograd Function against fp32 autograd of the plain semantics.
    Returns the cross-encoder case's errors by kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    failed, main = [], {}
    for name, q, k, v, bias, causal in flash_cases(gen):
        B, H, Lq, D = q.shape
        scale = D ** -0.5
        kb = key_bias(bias, B, k.shape[2])
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        out, stats = flash_fwd(q, k, v, kb, scale, causal)
        r_out, r_stats = plain_flash_fwd(q, k, v, kb, scale, causal)
        dq, delta = flash_dq(q, k, v, kb, out, stats, dout, scale, causal)
        r_dq, r_delta = plain_flash_dq(q, k, v, kb, out, stats, dout, scale, causal)
        dk, dv = flash_dkv(q, k, v, kb, stats, dout, delta, scale, causal)
        r_dk, r_dv = plain_flash_dkv(q, k, v, kb, stats, dout, delta, scale, causal)
        torch.cuda.synchronize()
        errs = {"out": (max_err(out, r_out), ulps_tol(r_out, FLASH_ULPS)),
                "dq": (max_err(dq, r_dq), ulps_tol(r_dq, FLASH_ULPS)),
                "dk": (max_err(dk, r_dk), ulps_tol(r_dk, FLASH_ULPS)),
                "dv": (max_err(dv, r_dv), ulps_tol(r_dv, FLASH_ULPS)),
                # row statistics and delta: fp32 sums in another order
                "lse": (max_err(stats[0] + stats[1], r_stats[0] + r_stats[1]), 1e-3),
                "delta": (max_err(delta, r_delta), 1e-3 * max(r_delta.abs().max().item(), 1.0))}
        # the Function (what the path calls) against fp32 autograd
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        f_out = flash_attention(*leaves, bias=bias, causal=causal)
        grad_fn = f_out.grad_fn.name() if f_out.grad_fn is not None else None
        f_out.backward(dout)
        ref_leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        ref = plain_flash_attention(*ref_leaves, bias=bias, causal=causal)
        ref.backward(dout.float())
        auto = {"out": (max_err(f_out, ref), ulps_tol(ref, FLASH_AUTOGRAD_ULPS)),
                **grad_errs(leaves, ref_leaves, "qkv", FLASH_AUTOGRAD_ULPS)}
        finite = all(bool(torch.isfinite(t).all().item()) for t in (out, dq, dk, dv))
        ok = finite and grad_fn is not None and all(e <= t for e, t in errs.values()) \
            and all(e <= t for e, t in auto.values())
        if name.startswith("fully_masked"):
            uniform = v[0].float().mean(dim=1, keepdim=True).expand(-1, Lq, -1)
            uerr = max_err(out[0], uniform)
            ok = ok and uerr <= ulps_tol(uniform, FLASH_ULPS)
            errs["uniform_row"] = (uerr, ulps_tol(uniform, FLASH_ULPS))
        emit(phase="flash_check", case=name, q=list(q.shape), k=list(k.shape), causal=causal,
             grad_fn=grad_fn, finite=finite,
             vs_plain={n: e for n, (e, _) in errs.items()},
             vs_plain_tol={n: t for n, (_, t) in errs.items()},
             vs_fp32_autograd={n: e for n, (e, _) in auto.items()},
             vs_fp32_autograd_tol={n: t for n, (_, t) in auto.items()}, ok=ok)
        if name == "cross_L430_ragged":
            main = {"flash_fwd": errs["out"][0], "flash_dq": errs["dq"][0],
                    "flash_dkv": max(errs["dk"][0], errs["dv"][0])}
        if not ok:
            failed.append(name)
    check(not failed, f"flash kernels disagree with their plain versions: {failed}")
    # a dtype the kernels do not take raises on the card, never runs plain
    x = torch.zeros(2, 2, 300, 64, device="cuda", dtype=torch.float16)
    try:
        flash_attention(x, x, x)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    emit(phase="flash_check", case="fp16_refused", refusal=refusal)
    check(refusal is not None, "flash_attention took a dtype its kernels do not take")
    return main


# ------------------------------------------------------------------ phase 3
def request(rng, caption="a person is cooking in a kitchen"):
    frames = rng.random((FRAMES, SIZE, SIZE, 3), dtype=np.float32)
    return {"caption": caption, "image_data": frames}


def serve(r: int, device: str = "cuda", extra=()):
    argv = ["--config", CONFIG, "--no_ckpt", "--device", device,
            "model_attributes.univl_retrieval.token_merge_r", str(r), *extra]
    predictor, _ = build_predictor(argv)
    return predictor


def phase_serving(rng):
    """Drive predict / predict_batch at r=8 and r=0; returns the predictors and
    the total kernel launches of this phase."""
    predictors, launches = {}, 0
    captions = ["a dog runs on the beach", "two people play tennis", "a man cooks pasta",
                "cars drive through a city at night", "a cat sleeps on a sofa",
                "children swim in a pool", "a woman plays the violin", "snow falls on trees"]
    for r in (8, 0):
        t0 = time.perf_counter()
        pred = serve(r)
        load_s = time.perf_counter() - t0
        small_attention.launches = 0
        t0 = time.perf_counter()
        one = pred.predict(request(rng))
        t_one = time.perf_counter() - t0
        n_one = small_attention.launches
        small_attention.launches = 0
        reqs = [request(rng, c) for c in captions]
        t0 = time.perf_counter()
        many = pred.predict_batch(reqs)
        t_many = time.perf_counter() - t0
        n_many = small_attention.launches
        launches += n_one + n_many
        check(n_one == 24 and n_many == 24,
              f"r={r}: kernel launches per forward {n_one}, {n_many}; expected 24")
        sim = np.asarray(one["sim"])
        te = np.asarray(one["text_embed"])
        rows = [np.asarray(m["sim"]) for m in many]
        norms = [float(np.linalg.norm(m["text_embed"])) for m in many]
        check(sim.shape == (1, 1) and te.shape == (1, 512), f"r={r}: predict shapes")
        check(all(x.shape == (8,) for x in rows), f"r={r}: predict_batch sim rows")
        check(all(np.isfinite(np.asarray(v)).all() for v in one.values()), f"r={r}: finite")
        check(all(np.isfinite(np.asarray(v)).all() for m in many for v in m.values()),
              f"r={r}: finite batch")
        check(abs(float(np.linalg.norm(te)) - 1) < 1e-3 and
              all(abs(n - 1) < 1e-3 for n in norms), f"r={r}: text_embed norms")
        emit(phase="serving", token_merge_r=r, load_s=load_s, predict_s=t_one,
             predict_batch8_s=t_many, launches_per_forward=[n_one, n_many],
             sim_b1=float(sim[0, 0]), sim_row0=rows[0].tolist())
        predictors[r] = pred
    return predictors, launches


# ------------------------------------------------------------------ phase 4
def compare(a, b):
    """Card outputs ``a`` against CPU outputs ``b``: per-row cosine of both
    embeddings and the largest |Δsim|."""
    def cos(x, y):
        x, y = x.reshape(-1).astype(np.float64), y.reshape(-1).astype(np.float64)
        return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))

    return dict(text_cos=cos(a["text_embed"], b["text_embed"]),
                visual_cos=cos(a["visual_embed"], b["visual_embed"]),
                max_abs_dsim=float(np.abs(a["sim"] - b["sim"]).max()),
                sim_card=float(a["sim"].reshape(-1)[0]), sim_cpu=float(b["sim"].reshape(-1)[0]))


def within_bound(res) -> bool:
    return res["text_cos"] >= COS_MIN and res["visual_cos"] >= COS_MIN \
        and res["max_abs_dsim"] <= DSIM_MAX


def cpu_twin():
    return serve(0, "cpu", ("model_attributes.univl_retrieval.dtype_str", "float32"))


def phase_card_vs_cpu(card, rng):
    cpu = cpu_twin()
    arrays = card.build_sample(request(rng)).arrays()
    res = compare(card.forward(arrays), cpu.forward(arrays))
    ok = within_bound(res)
    emit(phase="card_vs_cpu", token_merge_r=0, **res, cos_min=COS_MIN, dsim_max=DSIM_MAX,
         ok=ok)
    check(ok, "card and CPU disagree beyond the stated bound")


def planted_faults(module):
    """Path-level faults, planted on the card's model only, each undone after
    its forward: (name, plant, undo)."""
    from antmmf_torch.modules import layers
    from antmmf_torch.modules.encoders import text_encoder

    vit_mlps = [m for m in module.base.img_encoder.modules() if isinstance(m, layers.Mlp)]
    bert_norms = [m for m in module.base.text_encoder.modules()
                  if isinstance(m, layers.LayerNorm)]

    def set_mask(fn):
        text_encoder.make_attention_mask = fn

    def set_act(fn):
        for m in vit_mlps:
            m.act = fn

    def set_eps(eps):
        for m in bert_norms:
            m.epsilon = eps

    return [
        ("bert_key_bias_dropped", lambda: set_mask(lambda mask: None),
         lambda: set_mask(layers.make_attention_mask)),
        ("vit_quick_gelu_as_exact_gelu", lambda: set_act(layers.ACTIVATIONS["gelu_exact"]),
         lambda: set_act(layers.ACTIVATIONS["quick_gelu"])),
        ("bert_layernorm_eps_1e-5", lambda: set_eps(1e-5), lambda: set_eps(1e-12)),
    ]


def calibrate(seeds=5) -> None:
    """Phase 4's readings behind its bound: the card-vs-CPU gap of sound runs
    over several weight seeds, and of planted faults at seed 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    card, cpu = serve(0), cpu_twin()
    sound = []
    for seed in range(seeds):
        card.shell.init(seed)
        cpu.shell.init(seed)
        arrays = card.build_sample(request(rng)).arrays()
        ref = cpu.forward(arrays)
        res = compare(card.forward(arrays), ref)
        sound.append(res)
        emit(phase="calibrate", kind="sound", seed=seed, **res, within_bound=within_bound(res))
    for name, plant, undo in planted_faults(card.shell.module):
        plant()
        try:
            res = compare(card.forward(arrays), ref)
        finally:
            undo()
        emit(phase="calibrate", kind="fault", fault=name, seed=seeds - 1, **res,
             within_bound=within_bound(res))
    emit(phase="calibrate", kind="sound_worst", seeds=seeds,
         min_cos=min(min(r["text_cos"], r["visual_cos"]) for r in sound),
         max_abs_dsim=max(r["max_abs_dsim"] for r in sound),
         cos_min=COS_MIN, dsim_max=DSIM_MAX)


# ------------------------------------------------------------------ phase 5
def train_config(model: dict, dtype: str = "bfloat16") -> dict:
    """bench.py's training configuration, with ``model`` on top."""
    return {"model_attributes": {"univl_retrieval": {
                "vit_preset": "vit_base_patch32", "bert_preset": "bert_base",
                "image_size": SIZE, "embed_dim": 512, "n_clips": 1, "dtype_str": dtype,
                **model}},
            "optimizer_attributes": {"type": "adam_w", "params": {
                "lr": 5e-5, "weight_decay": 0.01, "mu_dtype": "bfloat16"}},
            "training_parameters": {"clip_gradients": True, "max_grad_l2_norm": 1.0}}


def train_batch(B: int, seed: int) -> dict:
    """bench.py's batch (8 frames of 224², ids of 30 tokens) with ragged
    captions, so the key-padding biases are live."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, TEXT_LEN + 1, B)
    mask = (np.arange(TEXT_LEN)[None] < lens[:, None]).astype(np.int64)
    return {"image_data": rng.standard_normal((B, FRAMES, SIZE, SIZE, 3)).astype(np.float32),
            "video_mask": np.ones((B, FRAMES), np.int64),
            "caption_input_ids": rng.integers(1, 30522, (B, TEXT_LEN)) * mask,
            "caption_input_mask": mask,
            "caption_segment_ids": np.zeros((B, TEXT_LEN), np.int64)}


def trainer(model: dict, device: str = "cuda", dtype: str = "bfloat16", seed: int = SEED,
            masters=None):
    """(shell, state, train_step) through the port's training entry points;
    seeded random weights unless fp32 ``masters`` are given."""
    cfg = train_config(model, dtype)
    shell = build_model(cfg, device=device)
    if masters is None:
        shell.init(seed)
    tx, _ = build_optimizer(flax_paths(shell.module), cfg["optimizer_attributes"],
                            cfg["training_parameters"])
    return shell, TrainState.create(shell.module, tx, masters), make_train_step(shell, tx)


def device_busy(prof, iters: int):
    """(device-busy ms, device operations, top operations by ms), per iteration."""
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(by_name.values()), len(ops) / iters, [[n[:90], ms] for n, ms in top]


def phase_training(gpu: str):
    """Both training legs; returns the path's launches by kernel and the
    cross-encoder's pair key bias (for phase 7's timing)."""
    from torch.profiler import ProfilerActivity, profile

    totals = dict.fromkeys(STEP_LAUNCHES["flagship"], 0)
    pair_bias = None
    for leg, (model, B) in TRAIN_LEGS.items():
        t0 = time.perf_counter()
        shell, state, step = trainer(model)
        batch = shell.to_device(train_batch(B, SEED + 1))
        setup_s = time.perf_counter() - t0
        losses, times, counts = [], [], []
        for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts.append(read_counts())
            losses.append(float(loss))
            for name, n in counts[-1].items():
                totals[name] += n
        timed = times[TRAIN_WARMUP:]
        p50 = float(np.percentile(timed, 50))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                state, loss = step(state, batch)
            torch.cuda.synchronize()
        busy, n_ops, top = device_busy(prof, 2)
        emit(phase="training", leg=leg, batch=B, gpu=gpu, setup_s=setup_s, losses=losses,
             step_ms=times, step_p50_ms=p50, step_p95_ms=float(np.percentile(timed, 95)),
             clip_pairs_per_s=B * len(timed) * 1e3 / float(np.sum(timed)),
             launches_per_step=counts[-1],
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             device_busy_ms=busy if n_ops else "not measured",
             device_idle_share=1 - busy / p50 if n_ops else "not measured",
             device_ops_per_step=n_ops, top_device_ops_ms=top)
        check(all(np.isfinite(losses)), f"{leg}: a loss is not finite")
        check(losses[-1] < losses[0], f"{leg}: the loss did not fall ({losses})")
        check(all(c == STEP_LAUNCHES[leg] for c in counts),
              f"{leg}: launches per step {counts[-1]}; expected {STEP_LAUNCHES[leg]}")
        if model.get("with_cross_encoder"):
            k = model["hard_mining_k"]
            text = batch["caption_input_mask"].repeat_interleave(k, dim=0)
            pair_bias = make_attention_mask(torch.cat(
                [text, torch.ones(B * k, FRAMES * VIT_TOKENS, dtype=text.dtype, device="cuda")], 1))
        del shell, state, step, batch
        torch.cuda.empty_cache()
    return totals, pair_bias


# ------------------------------------------------------------------ phase 6
def first_step(shell, batch):
    """The first training step's loss and fp32 gradients by parameter name."""
    for p in shell.module.parameters():
        p.grad = None
    loss, _ = shell.loss_fn(batch, deterministic=False)
    loss.backward()
    return loss.item(), {n: p.grad.float().cpu() for n, p in shell.module.named_parameters()
                         if p.grad is not None}


def compare_steps(card, cpu):
    """Card (loss, grads) against CPU (loss, grads): |Δloss|, the cosine of
    all gradients together and the least per-parameter cosine. A parameter
    whose CPU gradient is below 1e-3 of the median parameter's (the key
    projections' biases, whose exact gradient is 0) is left out and listed."""
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    norms = {n: g.norm().item() for n, g in g_cpu.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    cos, skipped = {}, []
    for n, g in g_cpu.items():
        if n not in g_card:
            cos[n] = 0.0  # a gradient the card never produced
        elif norms[n] <= floor:
            skipped.append(n)
        else:
            cos[n] = torch.nn.functional.cosine_similarity(
                g_card[n].double().reshape(-1), g.double().reshape(-1), dim=0).item()
    flat = [torch.cat([d[n].double().reshape(-1) for n in g_cpu]) if all(n in d for n in g_cpu)
            else None for d in (g_card, g_cpu)]
    overall = (torch.nn.functional.cosine_similarity(flat[0], flat[1], dim=0).item()
               if flat[0] is not None else 0.0)
    worst = min(cos, key=cos.get)
    return dict(loss_card=l_card, loss_cpu=l_cpu, abs_dloss=abs(l_card - l_cpu),
                grad_cos_all=overall, grad_cos_min=cos[worst], worst_param=worst,
                params_compared=len(cos), params_skipped=skipped)


def train_within_bound(res) -> bool:
    return res["grad_cos_all"] >= GRAD_COS_ALL and res["grad_cos_min"] >= GRAD_COS_MIN \
        and res["abs_dloss"] <= DLOSS_MAX


def train_twins(seed: int):
    """The cross-mined model on the CPU in fp32 (plain versions) and on the
    card in bf16, on the same fp32 master weights, and a B=4 batch."""
    cpu, cpu_state, _ = trainer(CROSS, "cpu", "float32", seed)
    card, _, _ = trainer(CROSS, masters=cpu_state.params)
    batch = train_batch(4, SEED + 2)
    return card, cpu, batch


def phase_train_card_vs_cpu():
    card, cpu, batch = train_twins(SEED)
    res = compare_steps(first_step(card, batch), first_step(cpu, batch))
    ok = train_within_bound(res)
    emit(phase="train_card_vs_cpu", batch=4, **res, grad_cos_all_bound=GRAD_COS_ALL,
         grad_cos_min_bound=GRAD_COS_MIN, dloss_max=DLOSS_MAX, ok=ok)
    check(ok, "card and CPU training steps disagree beyond the stated bound")


def train_faults():
    """Faults planted on the card's path only, each undone after its step:
    (name, plant, undo)."""
    from antmmf_torch.models import univl
    from antmmf_torch.modules import attention

    real_dkv, real_mask, real_small = fa.flash_dkv, univl.make_attention_mask, \
        attention.small_attention

    def dv_unnormalised(q, k, v, kb, stats, dout, delta, scale, causal):
        dk, _ = real_dkv(q, k, v, kb, stats, dout, delta, scale, causal)
        raw = torch.stack([stats[0], torch.zeros_like(stats[1])])  # log l = 0
        return dk, real_dkv(q, k, v, kb, raw, dout, delta, scale, causal)[1]

    # the wrapper counts its launches on whatever its module name holds
    dv_unnormalised.launches = 0

    def detached_small(q, k, v, bias=None, scale=None):
        # the repaired fault: the kernel's output written outside autograd
        B, H, L, D = q.shape
        return sa._forward(q, k, v, key_bias(bias, B, L), scale or D ** -0.5)

    def setter(obj, name, value):
        return lambda: setattr(obj, name, value)

    return [
        ("flash_dv_from_unnormalised_p", setter(fa, "flash_dkv", dv_unnormalised),
         setter(fa, "flash_dkv", real_dkv)),
        ("cross_key_bias_dropped", setter(univl, "make_attention_mask", lambda mask: None),
         setter(univl, "make_attention_mask", real_mask)),
        ("small_attention_output_without_grad_fn",
         setter(attention, "small_attention", detached_small),
         setter(attention, "small_attention", real_small)),
    ]


def calibrate_training(seeds=3) -> None:
    """Phase 6's readings: sound seeds, then planted faults at the last seed."""
    for seed in range(seeds):
        card, cpu, batch = train_twins(seed)
        ref = first_step(cpu, batch)
        res = compare_steps(first_step(card, batch), ref)
        emit(phase="calibrate_training", kind="sound", seed=seed, **res,
             within_bound=train_within_bound(res))
    for name, plant, undo in train_faults():
        plant()
        try:
            res = compare_steps(first_step(card, batch), ref)
        finally:
            undo()
        emit(phase="calibrate_training", kind="fault", fault=name, seed=seeds - 1, **res,
             within_bound=train_within_bound(res))
    emit(phase="calibrate_training", kind="bound", grad_cos_all=GRAD_COS_ALL,
         grad_cos_min=GRAD_COS_MIN, dloss_max=DLOSS_MAX)


# ------------------------------------------------------------------ phase 7
def cuda_ms(fn, iters=100, warmup=10):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters, warmup=5):
    for _ in range(warmup):
        fn()
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def pct(lat):
    return dict(n=len(lat), p50_ms=float(np.percentile(lat, 50)),
                p95_ms=float(np.percentile(lat, 95)), mean_ms=float(np.mean(lat)))


def phase_times(predictors, rng, gpu):
    pred = predictors[8]
    module = pred.shell.module
    tok = pred.build_sample({"caption": "a person is cooking in a kitchen"}).arrays()
    ids, mask, seg = (torch.as_tensor(tok[f"caption_{k}"]).cuda()
                      for k in ("input_ids", "input_mask", "segment_ids"))

    def text_query():
        with torch.inference_mode():
            module.base.forward_text_encoder(ids, mask, seg)["text_embed"].cpu()

    emit(phase="times", exp="text_query_encode_b1", token_merge_r=8, gpu=gpu,
         **pct(host_ms(text_query, 200)))
    walls = {}
    for r in (8, 0):
        module = predictors[r].shell.module
        for b in (1, 8, 32):
            batch = {"image_data": torch.as_tensor(
                        rng.random((b, FRAMES, SIZE, SIZE, 3), dtype=np.float32)).cuda(),
                     "caption_input_ids": ids.expand(b, -1), "caption_input_mask":
                        mask.expand(b, -1), "caption_segment_ids": seg.expand(b, -1)}

            def full(module=module, batch=batch):
                with torch.inference_mode():
                    out = module(batch)
                    out["visual_embed"].cpu()

            lat = host_ms(full, 30)
            walls[(r, b)] = (full, float(np.median(lat)))
            emit(phase="times", exp=f"full_encode_b{b}", token_merge_r=r, gpu=gpu,
                 **pct(lat), clips_per_s=b * 1e3 / float(np.mean(lat)))

    # the kernel at the ViT shape [256, 12, 50, 64] bf16, q/k/v as the
    # projections lay them out
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, H, L, D = 256, 12, 50, 64
    q, k, v = (torch.randn(B, L, H, D, generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    saved = small_attention.launches
    ms = cuda_ms(lambda: small_attention(q, k, v))
    small_attention.launches = saved  # timing launches are not path launches
    plain_ms = cuda_ms(lambda: plain_small_attention(q, k, v), iters=20)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    nbytes = 4 * B * H * L * D * 2
    flops = 4 * B * H * L * L * D
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit(phase="times", exp="small_attention_kernel", shape=[B, H, L, D], dtype="bf16",
         gpu=gpu, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
         bytes=nbytes, flops=flops, bound_share=bound_ms / ms)
    return walls, dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                       bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def bound(nbytes: float, flops: float) -> dict:
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def phase_flash_times(pair_bias, gpu) -> dict:
    """The flash kernels at the cross-encoder's [64, 12, 430, 64] bf16 with
    the training batch's pair key bias, q/k/v in the projections' layout.
    The bound counts each input read once and each output written once, and
    the products over the live keys of each row (4, 6 and 8 multiply-adds
    ·2 per query-key pair and head dimension for forward, dQ, dK/dV)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    P, L = pair_bias.shape[0], pair_bias.shape[3]
    H, D = 12, 64
    q, k, v = (torch.randn(P, L, H, D, generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    dout = torch.randn(P, H, L, D, generator=gen, device="cuda").to(torch.bfloat16)
    kb, scale = key_bias(pair_bias, P, L), D ** -0.5
    saved = read_counts()
    out, stats = flash_fwd(q, k, v, kb, scale, False)
    _, delta = flash_dq(q, k, v, kb, out, stats, dout, scale, False)
    live = int((kb > torch.finfo(torch.float32).min / 2).sum().item())  # live keys, all rows
    pairs = H * L * live  # (query, key) pairs over heads
    tensor, rows = P * H * L * D * 2, P * H * L * 4  # one bf16 [P, H, L, D]; one fp32 row stat
    bias_b = P * L * 4
    mask = pair_bias > torch.finfo(torch.float32).min / 2  # SDPA's boolean form
    timing = {
        "flash_fwd": dict(
            ms=cuda_ms(lambda: flash_fwd(q, k, v, kb, scale, False)),
            plain_ms=cuda_ms(lambda: plain_flash_fwd(q, k, v, kb, scale, False), iters=10),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
            **bound(4 * tensor + bias_b + 2 * rows, 4 * D * pairs)),
        "flash_dq": dict(
            ms=cuda_ms(lambda: flash_dq(q, k, v, kb, out, stats, dout, scale, False)),
            plain_ms=cuda_ms(lambda: plain_flash_dq(q, k, v, kb, out, stats, dout, scale,
                                                    False), iters=10),
            library_ms=None,
            **bound(6 * tensor + bias_b + 3 * rows, 6 * D * pairs)),
        "flash_dkv": dict(
            ms=cuda_ms(lambda: flash_dkv(q, k, v, kb, stats, dout, delta, scale, False)),
            plain_ms=cuda_ms(lambda: plain_flash_dkv(q, k, v, kb, stats, dout, delta, scale,
                                                     False), iters=10),
            library_ms=None,
            **bound(6 * tensor + bias_b + 3 * rows, 8 * D * pairs)),
    }
    # SDPA forward and backward together, the yardstick for the three kernels
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(*leaves, attn_mask=mask).backward(dout)

    def flash_fwd_bwd():
        o, st = flash_fwd(q, k, v, kb, scale, False)
        _, dl = flash_dq(q, k, v, kb, o, st, dout, scale, False)
        flash_dkv(q, k, v, kb, st, dout, dl, scale, False)

    sdpa_ms, family_ms = cuda_ms(sdpa_fwd_bwd, iters=20), cuda_ms(flash_fwd_bwd, iters=20)
    for fn in KERNELS:  # timing launches are not path launches
        fn.launches = saved[fn.__name__]
    for name, t in timing.items():
        emit(phase="times", exp=name, shape=[P, H, L, D], dtype="bf16", gpu=gpu, live_keys=live,
             **t, bound_share=t["bound_ms"] / t["ms"])
    emit(phase="times", exp="flash_fwd_dq_dkv_vs_sdpa_fwd_bwd", shape=[P, H, L, D], gpu=gpu,
         flash_ms=family_ms, sdpa_ms=sdpa_ms)
    return timing


# ------------------------------------------------------------------ phase 8
def phase_trace(walls, gpu, iters=5):
    from torch.profiler import ProfilerActivity, profile

    for r in (8, 0):
        full, wall_ms = walls[(r, 32)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                full()
        busy_ms, n_ops, top = device_busy(prof, iters)
        emit(phase="trace", exp="full_encode_b32", token_merge_r=r, gpu=gpu,
             untraced_wall_ms=wall_ms,
             device_busy_ms=busy_ms if n_ops else "not measured",
             device_idle_share=1 - busy_ms / wall_ms if n_ops else "not measured",
             device_ops_per_forward=n_ops, top_device_ops_ms=top)


SOURCES = {
    "small_attention": ("antmmf_torch/ops/csrc/small_attention.cu",
                        "antmmf_tpu/ops/pallas/small_attention.py:62"),
    "flash_fwd": ("antmmf_torch/ops/csrc/flash_attention.cu",
                  "antmmf_tpu/ops/pallas/flash_attention.py:385"),
    "flash_dq": ("antmmf_torch/ops/csrc/flash_attention.cu",
                 "antmmf_tpu/ops/pallas/flash_attention.py:434"),
    "flash_dkv": ("antmmf_torch/ops/csrc/flash_attention.cu",
                  "antmmf_tpu/ops/pallas/flash_attention.py:460"),
}


def main() -> None:
    gpu = gpu_line()
    emit(phase="card", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _build.build()
    emit(phase="build", library=lib, seconds=time.perf_counter() - t0)

    errs = {"small_attention": phase_kernels(), **phase_flash()}
    rng = np.random.default_rng(SEED)
    zero_counts()
    predictors, serving = phase_serving(rng)
    check(not any(flash.launches for flash in KERNELS[1:]), "serving launched a flash kernel")
    check(serving > 0, "the serving path never launched the kernel")
    phase_card_vs_cpu(predictors[0], rng)
    launches, pair_bias = phase_training(gpu)
    launches["small_attention"] += serving
    phase_train_card_vs_cpu()
    walls, timing = phase_times(predictors, rng, gpu)
    timing = {"small_attention": timing, **phase_flash_times(pair_bias, gpu)}
    phase_trace(walls, gpu)

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches[name],
        "max_abs_err": errs[name], **timing[name]} for name in SOURCES]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--calibrate"]:
        calibrate()
        calibrate_training()
    elif sys.argv[1:]:
        sys.exit("usage: python3 chip_smoke.py [--calibrate]")
    else:
        main()
