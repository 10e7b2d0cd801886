"""Drive the antmmf_torch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py              # from the repository root, on a machine with CUDA
    python3 chip_smoke.py --calibrate  # phase 4's readings: seeds and planted faults

Phases, each printing JSON lines; a failing phase ends the script with a
non-zero code and no result line:

1. card and build: the GPU's name and power limit (``nvidia-smi``), the
   kernels built from ``antmmf_torch/ops/csrc`` with ``nvcc``; TF32 is turned
   off so fp32 checks are exact;
2. kernel vs plain: ``small_attention`` against ``plain_small_attention`` on
   the same inputs at the serving path's shapes, bf16 and fp32;
3. serving: ``projects/base_vtp/configs/serving.yml`` at full width (ViT-B/32
   at 8x224², BERT-base at L=30, bf16, seeded random weights) through the
   port's CLI and predictor code: one ``predict`` and one ``predict_batch`` of
   8, at ``token_merge_r`` 8 (as shipped) and 0; every forward must launch the
   attention kernel 24 times (12 ViT + 12 BERT layers);
4. card vs CPU: the same weights in fp32 on the CPU (plain versions) against
   bf16 on the card, r=0, one request, held to the bound that ``--calibrate``
   reads from sound seeds and planted faults;
5. times: text-query and full-encode latency, the kernel's time beside its
   bound, its plain version and the library call, each with the GPU's name and
   power limit;
6. trace: ``torch.profiler`` over full encodes at B=32: device-busy time per
   forward against the untraced wall time (the device's idle share), device
   operations (kernels and copies) per forward and those that take the most
   device time.

The line before the last holds the kernel table, the last line the result.
Without CUDA the script exits non-zero before printing anything.
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

from antmmf_torch.modules.layers import make_attention_mask  # noqa: E402
from antmmf_torch.ops import _build  # noqa: E402
from antmmf_torch.ops.small_attention import (  # noqa: E402
    plain_small_attention,
    small_attention,
)
from antmmf_torch.predictors.cli import build_predictor  # noqa: E402

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
    return worst_main


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


# ------------------------------------------------------------------ phase 6
def phase_trace(walls, gpu, iters=5):
    from torch.profiler import ProfilerActivity, profile

    for r in (8, 0):
        full, wall_ms = walls[(r, 32)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                full()
        device_ops = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in device_ops:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
        busy_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        emit(phase="trace", exp="full_encode_b32", token_merge_r=r, gpu=gpu,
             untraced_wall_ms=wall_ms,
             device_busy_ms=busy_ms if device_ops else "not measured",
             device_idle_share=1 - busy_ms / wall_ms if device_ops else "not measured",
             device_ops_per_forward=len(device_ops) / iters,
             top_device_ops_ms=[[name[:90], ms] for name, ms in top])


def main() -> None:
    gpu = gpu_line()
    emit(phase="card", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _build.build()
    emit(phase="build", library=lib, seconds=time.perf_counter() - t0)

    max_err = phase_kernels()
    rng = np.random.default_rng(SEED)
    small_attention.launches = 0
    predictors, launches = phase_serving(rng)
    check(launches > 0, "the serving path never launched the kernel")
    phase_card_vs_cpu(predictors[0], rng)
    walls, timing = phase_times(predictors, rng, gpu)
    phase_trace(walls, gpu)

    print(json.dumps({"kernels": [{
        "name": "small_attention", "route": "cuda",
        "source": "antmmf_torch/ops/csrc/small_attention.cu",
        "replaces": "antmmf_tpu/ops/pallas/small_attention.py:62",
        "launches": launches, "max_abs_err": max_err, **timing}]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--calibrate"]:
        calibrate()
    elif sys.argv[1:]:
        sys.exit("usage: python3 chip_smoke.py [--calibrate]")
    else:
        main()
