"""Times the kernels of one source tree on the card, at the main paths'
shapes, beside the library call that computes the same function.

    python3 antmmf_torch/ops/kernel_times.py [--tree DIR] [--label NAME] [--rounds N]
                                             [--kernels small_attention,flash_fwd,...]
                                             [--rows 1,8,32]

``--tree`` is the directory whose ``antmmf_torch`` package is imported
(default: the one this file belongs to), so two trees (a parent commit
unpacked with ``git archive`` beside the working tree, or copies that differ
in one tiling constant) can be timed in turns on one card: run the script
once per tree and round inside one shell command. Every tree builds its own
kernels under its own ``build/``.

Each reading is device time per launch: 20 launches captured in a CUDA graph
and replayed, timed with CUDA events, so the host's launch cost stays out of
it (it would swamp the one-sample shapes). One JSON line per kernel and
shape, with the card's name and power limit as ``nvidia-smi`` gives them.
Every attention row carries ``bound_us``, the least time the card could
take (each input read once, each output written once at 3.35 TB/s; the
products over the attended (query, key) pairs at 989 TFLOP/s bf16; the
larger of the two). For ``flash_dq`` and ``flash_dkv`` K and V count only
the rows of live keys where no row is fully masked (``flash_bwd_bytes``);
the pair's row carries the sum of the two. Pink's training steps (causal,
D=128, a ragged text bias: 16 heads, k/v repeated from 4 kv heads, behind
49 vision keys; and ``pink_7b.yml``'s 32 heads, k/v from 8 kv heads, behind
256 EVA tokens) have rows of their own, as have M2-omni's prefill
([1, 32, 640, 128], causal, right-padded, k/v from 8 kv heads) and its conv
audio tower's K1 ([1, 4, 64, 128]).
The backward pair is also timed as one row, ``flash_dq+flash_dkv``, against
SDPA's backward alone (``sdpa_bwd``: the forward run once outside the graph,
``torch.autograd.grad`` captured), with the SDPA kernels that ran.

``int4_gemv`` (K8) is timed on random records of the Pink decode path's five
weight shapes (seeded; no model needed) at 1, 8 and 32 rows of bf16 x,
beside bf16 ``torch.matmul`` on the dequantised weight (``library_us``). Its
graph cycles through copies of the record (about 256 MB of them), so that no
launch finds its weights in the 50 MB L2 cache, as a decode step finds them.
Then an ``int4_gemv_step`` row for each row count sums each shape's time
times its launches in a decode step (155 launches).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores (data sheet)
LOG2E, FLT_MAX = 1.4426950408889634, 3.4028234663852886e38  # a key bias as the kernels read it
# the Pink decode path's int4 records: (x columns, record rows, out, group,
# launches a decode step); down_proj is stored row-padded at group 88
INT4_SHAPES = {"attn_q_o": (2048, 2048, 2048, 128, 44),
               "attn_k_v": (2048, 2048, 512, 128, 44),
               "mlp_gate_up": (2048, 2048, 5504, 128, 44),
               "mlp_down": (5504, 5632, 2048, 88, 22),
               "lm_head": (2048, 2048, 151936, 128, 1)}
INT4_ROWS = (1, 8, 32)


def graph_ms(fn, launches: int = 20, replays: int = 10, stream=None) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(launches):
            fn()
    for _ in range(2):
        graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def events_ms(fn, launches: int = 20) -> float:
    """Device time per call of ``launches`` back-to-back calls, CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def sdpa_backward_ms(q, k, v, mask, dout, with_forward: bool = False):
    """(ms, method): SDPA's backward alone (or, ``with_forward``, forward and
    backward) on q/k/v with the boolean ``attn_mask`` and cotangent ``dout``,
    device time per call. Autograd runs each backward op on the stream of its
    forward, so the forward runs on the stream the graph is captured on;
    ``torch.autograd.grad`` is captured, and the grads go nowhere but the
    graph's pool. Where capture fails, 20 back-to-back calls are timed with
    CUDA events instead, and ``method`` says so."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)

        def call():
            o = F.scaled_dot_product_attention(*leaves, attn_mask=mask) if with_forward else out
            return torch.autograd.grad(o, leaves, dout, retain_graph=not with_forward)

        try:
            return graph_ms(call, stream=stream), "cuda_graph"
        except RuntimeError as e:  # capture refused on this torch
            torch.cuda.synchronize()
            return events_ms(call), f"cuda_events ({str(e).splitlines()[0][:120]})"


def sdpa_kernels(q, k, v, mask, dout) -> list:
    """The device kernels of one SDPA forward and backward, by device time:
    the names say which backend ran."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
    times: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us()
    return [[name[:100], us] for name, us in sorted(times.items(), key=lambda kv: -kv[1])[:6]]


def cycled(call, copies: int, **meta):
    """A call that takes the next of ``copies`` operand sets each time, so a
    graph of ``copies`` launches (``fn.launches``) meets cold operands."""
    turn = itertools.count()

    def fn():
        return call(next(turn) % copies)

    fn.launches, fn.meta = copies, meta
    return fn


def int4_cases(torch, i4, row_counts=INT4_ROWS):
    """K8 rows: for each of the decode path's record shapes, seeded random
    packed bytes and scales, copied until the copies pass 256 MB; x of 1, 8
    and 32 rows. The library call is bf16 ``torch.matmul`` on the
    dequantised weight, cycled the same way."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    for name, (fin_x, fin_w, fout, group, per_step) in INT4_SHAPES.items():
        packed = torch.randint(0, 256, (fin_w // 2, fout), generator=gen, device="cuda",
                               dtype=torch.uint8)
        scale = torch.rand(fin_w // group, fout, generator=gen, device="cuda") * 0.01 + 0.005
        nbytes = packed.numel() + scale.numel() * 4
        copies = max(2, min(512, -(-256 * 2 ** 20 // nbytes)))
        records = [(packed.clone(), scale.clone()) for _ in range(copies)]
        dense = i4.unpack_int4(packed, scale, torch.bfloat16)[:fin_x]
        dense = [dense.clone() for _ in range(max(2, copies // 4))]
        for rows in row_counts:
            x = torch.randn(rows, fin_x, generator=gen, device="cuda").to(torch.bfloat16)
            moved = nbytes + x.numel() * 2 + rows * fout * 4
            meta = dict(rows=rows, launches_per_step=per_step,  # bound: bytes once
                        bound_us=moved / HBM_BYTES_PER_S * 1e6)
            yield ("int4_gemv", f"{name}_{rows}x{fin_x}_to_{fout}",
                   cycled(lambda i, x=x: i4.int4_gemv(x, *records[i]), copies, **meta),
                   cycled(lambda i, x=x: torch.matmul(x, dense[i]), len(dense)))


def bound_us(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e6


def flash_bwd_bytes(kb, B: int, H: int, Lq: int, Lk: int, D: int, causal: bool):
    """(dq, dkv): the bytes ``flash_dq`` and ``flash_dkv`` must move, each
    input read once and each output written once: bf16 [B, H, L, D]
    tensors, the fp32 row statistics (m, log l) and delta, the fp32 key bias
    ``kb`` [B, Lk] or None. K and V count the rows these inputs need: in a
    sample with no fully masked row, its live keys only (a bias above
    finfo.min once in log2 units, as the kernels read it), since every
    other key's P is exactly 0; in a sample with one (causal: its first key
    masked; otherwise: no key live), all Lk. dK and dV are written whole."""
    if kb is None:
        kv_rows = B * Lk
    else:
        live = kb.double() * LOG2E > -FLT_MAX
        full = ~live[:, 0] if causal else ~live.any(dim=1)
        kv_rows = int(live.sum(dim=1).masked_fill(full, Lk).sum().item())
    q, kv, k = B * H * Lq * D * 2, H * kv_rows * D * 2, B * H * Lk * D * 2
    rows, bias = B * H * Lq * 4, 0 if kb is None else B * Lk * 4
    # dQ reads q, o, dout, k, v, m, log l; writes dq and delta.
    # dK/dV reads q, dout, k, v, m, log l, delta; writes dk and dv.
    return 4 * q + 2 * kv + bias + 3 * rows, 2 * q + 2 * kv + 2 * k + bias + 3 * rows


def cases(torch, sa, fa):
    """(kernel, shape name, port call, library, bound in µs): the
    library call timed the same way, or None, or for the backward pair the
    SDPA inputs (q, k, v, mask, dout) whose backward ``sdpa_backward_ms``
    times alone."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    fmin = torch.finfo(torch.float32).min

    def proj(B, L, H, D):  # the [B, L, H, D] projection layout seen as [B, H, L, D]
        return torch.randn(B, L, H, D, generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)

    def pad_bias(B, L, lo, live_tail=0):
        lens = torch.randint(lo, L + 1, (B,), generator=gen, device="cuda")
        live = torch.arange(L, device="cuda")[None] < lens[:, None]
        live = torch.cat([live, torch.ones(B, live_tail, dtype=torch.bool, device="cuda")], 1)
        return torch.where(live, 0.0, fmin).float().contiguous(), live[:, None, None, :]

    def small(name, B, H, L, D, bias, lo=5):
        q, k, v = (proj(B, L, H, D) for _ in range(3))
        kb, mask = pad_bias(B, L, lo) if bias else (None, None)
        live = int(mask.sum().item()) if bias else B * L
        return ("small_attention", name,
                lambda: sa.small_attention(q, k, v, kb),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                bound_us(4 * B * H * L * D * 2 + (B * L * 4 if bias else 0),
                         4 * H * L * live * D))

    yield small("vit_256x12x50x64", 256, 12, 50, 64, False)
    yield small("bert_32x12x30x64_pad", 32, 12, 30, 64, True)
    yield small("pink_vit_1x12x50x64", 1, 12, 50, 64, False)
    # DMAE's temporal encoder at B=128: 12 frames, 8 heads of 64, a frame
    # padding bias (at least 8 live frames)
    yield small("dmae_temporal_128x8x12x64_framepad", 128, 8, 12, 64, True, lo=8)
    # M2-omni's conv audio tower: 4 heads of 128 over 64 frames, one request
    yield small("m2_audio_1x4x64x128", 1, 4, 64, 128, False)

    def backward_rows(name, q, k, v, kb, out, stats, dout, delta, mask, causal, pairs):
        """flash_dq, flash_dkv and the pair against SDPA's backward; bounds
        from ``flash_bwd_bytes`` and the products over the ``pairs``
        attended (query, key) pairs of all heads (6 and 8 multiply-adds ·2
        per pair and head dimension); the pair's bound is their sum."""
        B, H, Lq, D = q.shape
        scale = D ** -0.5
        dq_bytes, dkv_bytes = flash_bwd_bytes(kb, B, H, Lq, k.shape[2], D, causal)
        dq_bound = bound_us(dq_bytes, 6 * D * pairs)
        dkv_bound = bound_us(dkv_bytes, 8 * D * pairs)
        yield ("flash_dq", name,
               lambda: fa.flash_dq(q, k, v, kb, out, stats, dout, scale, causal), None, dq_bound)
        yield ("flash_dkv", name,
               lambda: fa.flash_dkv(q, k, v, kb, stats, dout, delta, scale, causal), None,
               dkv_bound)

        def backward():
            _, dl = fa.flash_dq(q, k, v, kb, out, stats, dout, scale, causal)
            fa.flash_dkv(q, k, v, kb, stats, dout, dl, scale, causal)

        yield ("flash_dq+flash_dkv", name, backward, (q, k, v, mask, dout),
               dq_bound + dkv_bound)

    def pairs(P, name, forward_only=False):
        """The cross-encoder's pair stream: up to 30 text tokens (ragged) then
        400 live frame tokens, P pairs."""
        q, k, v = (proj(P, 430, 12, 64) for _ in range(3))
        dout = torch.randn(P, 12, 430, 64, generator=gen, device="cuda").to(torch.bfloat16)
        kb, mask = pad_bias(P, 30, 8, live_tail=400)
        scale = 64 ** -0.5
        out, stats = fa.flash_fwd(q, k, v, kb, scale, False)
        _, delta = fa.flash_dq(q, k, v, kb, out, stats, dout, scale, False)
        live = int(mask.sum().item())
        yield ("flash_fwd", name, lambda: fa.flash_fwd(q, k, v, kb, scale, False),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
               bound_us(4 * P * 12 * 430 * 64 * 2 + P * 430 * 4 + 2 * P * 12 * 430 * 4,
                        4 * 12 * 430 * live * 64))
        if forward_only:
            return
        yield from backward_rows(name, q, k, v, kb, out, stats, dout, delta, mask, False,
                                 12 * 430 * live)

    def pink_train(B, H=16, kv_heads=4, vision=49):
        """Pink's training step: causal, H heads of 128, k/v repeated from
        ``kv_heads`` kv heads, ``vision`` live vision keys then 8..256 live
        text keys (omni_1b behind ViT-B/32: 16, 4, 49; pink_7b.yml's omni_7b
        behind EVA-CLIP-g: 32, 8, 256); SDPA gets the key mask and the causal
        triangle as one boolean [B, 1, L, L]."""
        L, D = vision + 256, 128
        q = proj(B, L, H, D)
        k, v = (proj(B, L, kv_heads, D).contiguous().repeat_interleave(H // kv_heads, dim=1)
                for _ in range(2))
        dout = torch.randn(B, H, L, D, generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.randint(8, 257, (B,), generator=gen, device="cuda")
        live = torch.cat([torch.ones(B, vision, dtype=torch.bool, device="cuda"),
                          torch.arange(256, device="cuda")[None] < lens[:, None]], 1)
        kb = torch.where(live, 0.0, fmin).float().contiguous()
        mask = live[:, None, None, :] & torch.ones(L, L, dtype=torch.bool, device="cuda").tril()
        scale = D ** -0.5
        out, stats = fa.flash_fwd(q, k, v, kb, scale, True)
        _, delta = fa.flash_dq(q, k, v, kb, out, stats, dout, scale, True)
        pairs = H * int(mask.sum().item())
        name = f"pink_train_{B}x{H}x{L}x{D}_causal_ragged"
        yield ("flash_fwd", name, lambda: fa.flash_fwd(q, k, v, kb, scale, True),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
               bound_us(4 * B * H * L * D * 2 + B * L * 4 + 2 * B * H * L * 4, 4 * D * pairs))
        yield from backward_rows(name, q, k, v, kb, out, stats, dout, delta, mask, True, pairs)

    # 64 mined pairs a cross-mined step; 128 pairs a pretraining VTM or MLM pass
    yield from pairs(64, "cross_64x12x430x64_ragged")
    yield from pairs(128, "pretrain_128x12x430x64_ragged")
    # a stage-2 re-ranking chunk of 32 pairs (retrieval_trainer), forward only
    yield from pairs(32, "stage2_32x12x430x64_ragged", forward_only=True)
    yield from pink_train(8)
    yield from pink_train(8, 32, 8, 256)
    pq, pk, pv = (proj(1, 113, 16, 128) for _ in range(3))
    yield ("flash_fwd", "pink_prefill_1x16x113x128_causal",
           lambda: fa.flash_fwd(pq, pk, pv, None, 128 ** -0.5, True),
           lambda: F.scaled_dot_product_attention(pq, pk, pv, is_causal=True),
           bound_us(4 * pq.numel() * 2 + 2 * 16 * 113 * 4, 4 * 128 * 16 * 113 * 114 // 2))
    # M2-omni's prefill: a prompt of 640 slots, 430 of them live (right
    # padding), causal, 32 heads of 128, k/v repeated from 8 kv heads
    mq = proj(1, 640, 32, 128)
    mk, mv = (proj(1, 640, 8, 128).contiguous().repeat_interleave(4, dim=1) for _ in range(2))
    m_live = torch.arange(640, device="cuda")[None] < 430
    m_kb = torch.where(m_live, 0.0, fmin).float().contiguous()
    m_mask = m_live[:, None, None, :] & torch.ones(640, 640, dtype=torch.bool,
                                                   device="cuda").tril()
    yield ("flash_fwd", "m2_prefill_1x32x640x128_causal_padded",
           lambda: fa.flash_fwd(mq, mk, mv, m_kb, 128 ** -0.5, True),
           lambda: F.scaled_dot_product_attention(mq, mk, mv, attn_mask=m_mask),
           bound_us(4 * mq.numel() * 2 + 640 * 4 + 2 * 32 * 640 * 4,
                    4 * 128 * 32 * int(m_mask.sum().item())))


def time_attention(args, gpu, torch, sa, fa, only) -> None:
    for kernel, shape, port, library, bound in list(cases(torch, sa, fa)):
        if only and kernel not in only:
            continue
        ms = [graph_ms(port) for _ in range(args.rounds)]
        extra = {}
        if isinstance(library, tuple):  # SDPA's backward, alone and with its forward
            bwd = [sdpa_backward_ms(*library) for _ in range(args.rounds)]
            both = [sdpa_backward_ms(*library, with_forward=True) for _ in range(args.rounds)]
            lib = [x for x, _ in bwd]
            extra = {"library": "sdpa_bwd", "sdpa_method": bwd[0][1],
                     "sdpa_fwd_bwd_us": [round(x * 1e3, 2) for x, _ in both],
                     "sdpa_kernels_us": sdpa_kernels(*library)}
        else:
            lib = [graph_ms(library) for _ in range(args.rounds)] if library else None
        print(json.dumps({"tree": args.label, "kernel": kernel, "shape": shape, "gpu": gpu,
                          "us": [round(x * 1e3, 2) for x in ms],
                          "sdpa_us": lib and [round(x * 1e3, 2) for x in lib],
                          "bound_us": bound, **extra}), flush=True)


def time_int4(args, gpu, torch, i4) -> None:
    """A row per K8 shape and row count, then per row count the sums over a
    decode step's launches, round by round."""
    steps: dict = {}
    row_counts = [int(r) for r in args.rows.split(",")]
    for kernel, shape, port, library in int4_cases(torch, i4, row_counts):
        ms = [graph_ms(port, port.launches) for _ in range(args.rounds)]
        lib = [graph_ms(library, library.launches) for _ in range(args.rounds)]
        meta = port.meta
        print(json.dumps({"tree": args.label, "kernel": kernel, "shape": shape, "gpu": gpu,
                          "us": [round(x * 1e3, 3) for x in ms], "library": "bf16_matmul",
                          "library_us": [round(x * 1e3, 3) for x in lib],
                          "copies_in_turn": port.launches, **meta}), flush=True)
        step = steps.setdefault(meta["rows"], dict(us=[0.0] * args.rounds,
                                                   library_us=[0.0] * args.rounds,
                                                   bound_us=0.0, launches=0))
        n = meta["launches_per_step"]
        step["us"] = [s + n * x * 1e3 for s, x in zip(step["us"], ms)]
        step["library_us"] = [s + n * x * 1e3 for s, x in zip(step["library_us"], lib)]
        step["bound_us"] += n * meta["bound_us"]
        step["launches"] += n
    for rows, step in steps.items():
        print(json.dumps({"tree": args.label, "kernel": "int4_gemv_step", "rows": rows,
                          "gpu": gpu, **step}), flush=True)


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=here)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default="", help="comma-separated; default all")
    ap.add_argument("--rows", default=",".join(map(str, INT4_ROWS)),
                    help="int4_gemv: rows of x, comma-separated")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_times.py needs a CUDA device")
    from antmmf_torch.ops import flash_attention as fa
    from antmmf_torch.ops import int4_matmul as i4
    from antmmf_torch.ops import small_attention as sa

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    only = set(filter(None, args.kernels.split(",")))
    if not only or only - {"int4_gemv"}:
        time_attention(args, gpu, torch, sa, fa, only)
    if not only or "int4_gemv" in only:
        time_int4(args, gpu, torch, i4)


if __name__ == "__main__":
    main()
