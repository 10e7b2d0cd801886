"""Sequence parallelism over the mesh's ``seq`` axis: Ulysses and ring attention.

Port of ``antmmf_tpu/parallel/long_context.py``. The JAX functions take
global arrays and run inside ``shard_map``; here each rank of a ``seq``
process group holds its slice of the token stream, [B, H, L/P, D], and
the functions take those slices and the group:

* ``ulysses_attention``: the all-to-all head exchange. Heads are
  zero-padded to a multiple of the axis size P; each rank then holds the
  whole sequence for H/P heads, attends there, and a second all-to-all
  gives the slices back. The key bias is gathered along. The local
  attention is the port's own router: ``modules.attention.attention_core``
  (K1 up to 256 tokens, the flash family past them) or, with ``causal``,
  the causal flash kernels, as ``GQAttention`` runs them in one process.
  GQA callers expand K/V to the query heads first, as in JAX.
* ``ring_attention``: K/V blocks rotate around the ring (``ppermute``) at
  the kv-head count, their key bias with them, and the blocks' results
  merge by their softmax statistics; with ``causal`` a key's position is
  its source shard's offset plus its index. One autograd Function: the
  forward keeps only its inputs, the output and the merged row statistics;
  the backward rotates the blocks again, recomputes each block's
  probabilities from those statistics (``jax.checkpoint`` of each ring
  step in JAX), and the dK/dV of a block travel on with it until they are
  back at its owner, summed over the ranks that saw it.

  Two routes compute one function. On CPU tensors the plain ring step is
  JAX's: an fp32 einsum online softmax over every block (future blocks
  masked by -1e30, so a row with no live key averages them all, as JAX
  does), with GQA's rep query heads folded into the rows. On CUDA tensors
  each block is a launch of the flash kernels: ``flash_fwd`` on (this
  rank's queries, the block's K/V expanded to the query heads, its key
  bias), causal only on the diagonal block (top-left alignment is right
  there, Lq = Lk), no mask on blocks from earlier shards, and blocks from
  later ones skipped; the blocks merge through the (m, log l) rows
  ``flash_fwd`` returns, kept as an unevaluated sum so a fully masked row
  survives. The backward runs ``flash_dq`` and ``flash_dkv`` on each block
  against the merged statistics, the global output and its cotangent; a
  block's dK/dV are summed over its head group before they travel. This
  never holds the fp32 [rows, L/P] logits the einsum step makes (4 GB a
  step at 7.9k-token blocks). A block the kernels refuse raises; nothing
  falls back to the plain step. A row whose visible keys are all masked
  averages the keys the kernel saw (the diagonal block's up to the row, and
  the earlier blocks'); such rows are padding, which nothing reads.

``pad_seq_to_axis``, ``shard_seq`` and ``gather_seq`` carry a replicated
stream onto the axis and back: an encoder's attention (``sp_attention``)
pads L to a multiple of P with masked keys, takes its slice, runs either
function and gathers the result (whose backward is the reduce-scatter,
``collectives.all_gather_seq``). A decoder holds its stream sharded from
the first layer to the loss (``modules/llm.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from antmmf_torch.ops import flash_attention as fa
from antmmf_torch.ops.small_attention import key_bias
from antmmf_torch.parallel import collectives as coll

MASKED = -1e30  # the JAX package's additive mask of a padded key
MODES = ("none", "ring", "ulysses")


def check_mode(mode: Optional[str]) -> str:
    """The knob's value, a config's null read as ``none``."""
    mode = "none" if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"sequence_parallel must be one of {MODES}, got {mode!r}")
    return mode


def _kbias(bias: Optional[torch.Tensor], B: int, L: int, device) -> torch.Tensor:
    """Any key bias ([B|1, 1, 1, L] or [B, L]) as a contiguous fp32 [B, L]; zeros for None."""
    if bias is None:
        return torch.zeros(B, L, dtype=torch.float32, device=device)
    if bias.dim() == 4 and bias.shape[0] == 1 and B > 1:
        bias = bias.expand(B, -1, -1, -1)
    return key_bias(bias, B, L, "sequence parallel attention").float().contiguous()


def pad_seq_to_axis(q, k, v, bias, n: int):
    """L (dim 2) padded up to a multiple of ``n``; padded keys get ``MASKED``
    in the key bias [B, L'] (zeros where the caller gave none). Returns
    (q, k, v, bias, the original L); callers slice [:L] after."""
    B, L = q.shape[0], q.shape[2]
    kb = _kbias(bias, B, L, q.device)
    pad = (-L) % n
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        kb = F.pad(kb, (0, pad), value=MASKED)
    return q, k, v, kb, L


def shard_seq(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice of a replicated ``x`` along ``dim`` (of a multiple of
    the axis size); the backward puts the cotangent in its slice, zeros
    elsewhere."""
    return x.chunk(coll.axis_size(group), dim)[coll.axis_index(group)]


def pad_shard(x: torch.Tensor, group, dim: int, value=0) -> torch.Tensor:
    """``x`` padded along ``dim`` with ``value`` to a multiple of the axis
    size, then this rank's slice of it (``shard_seq``)."""
    pad = (-x.shape[dim]) % coll.axis_size(group)
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_full(shape, value)], dim=dim)
    return shard_seq(x, group, dim)


def gather_seq(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's slice along ``dim`` in axis order, with the
    reduce-scatter backward."""
    if coll.axis_size(group) == 1:
        return x
    return coll.all_gather_seq(x, group, dim)


# ----------------------------------------------------------------- Ulysses
def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                      bias: Optional[torch.Tensor] = None, causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention by head exchange over this rank's slices q, k, v
    [B, H, L/P, D] (K/V at the query head count) and their key bias [B, L/P]
    (or [B, 1, 1, L/P]); returns this rank's slice of the output."""
    from antmmf_torch.modules.attention import attention_core

    n = coll.axis_size(group)
    B, H, Lb, _ = q.shape
    kb = _kbias(bias, B, Lb, q.device) if bias is not None else None
    pad_h = (-H) % n
    if pad_h:  # zero heads attend over zero K/V and are sliced away
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad_h)) for t in (q, k, v))
    qh, kh, vh = (coll.all_to_all(t, group, 1, 2) for t in (q, k, v))  # [B, H/P, L, D]
    full_bias = None if kb is None else torch.cat(coll.gather_list(kb, group), dim=1) \
        if n > 1 else kb
    if causal:
        out = fa.flash_attention(qh, kh, vh, bias=full_bias, scale=scale, causal=True)
    else:
        out = attention_core(qh, kh, vh, scale=scale,
                             bias=None if full_bias is None else full_bias[:, None, None, :])
    return coll.all_to_all(out, group, 2, 1)[:, :H]


# -------------------------------------------------------------------- ring
def _expand(t: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, Hkv, L, D] → [B, Hkv·rep, L, D], head h reading kv head h // rep."""
    return t if rep == 1 else t.repeat_interleave(rep, dim=1)


def _fold(t: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, Hkv·rep, ...] → [B, Hkv, rep, ...] summed over the group's rep heads."""
    if rep == 1:
        return t
    B, H = t.shape[:2]
    return t.reshape(B, H // rep, rep, *t.shape[2:]).sum(2)


def _positions(me: int, src: int, Lb: int, rep: int, device) -> Tuple[torch.Tensor, ...]:
    q_pos = (me * Lb + torch.arange(Lb, device=device)).repeat(rep)
    k_pos = src * Lb + torch.arange(Lb, device=device)
    return q_pos, k_pos


class _RingState:
    """What one ring pass knows: the group, this rank's coordinate, the
    shapes and the routes' choices."""

    def __init__(self, q, k, group, scale, causal, blocks):
        self.group, self.n, self.me = group, coll.axis_size(group), coll.axis_index(group)
        self.B, self.H, self.Lb, self.D = q.shape
        self.Hkv = k.shape[1]
        self.rep = self.H // self.Hkv
        self.scale, self.causal = scale, causal
        self.kernels = blocks == "flash" or (blocks == "auto" and q.is_cuda)

    def src(self, s: int) -> int:
        return (self.me - s) % self.n

    def skipped(self, s: int) -> bool:
        """A block the kernels skip: from a later shard, under causal."""
        return self.kernels and self.causal and self.src(s) > self.me

    def folded_q(self, q: torch.Tensor) -> torch.Tensor:
        """JAX's fold: q head h = g·rep + r → rows r·Lb.. of group g, fp32."""
        return q.float().contiguous().reshape(self.B, self.Hkv, self.rep * self.Lb, self.D)

    def plain_logits(self, qf, kb, bb, s: int):
        """The plain step's fp32 block logits [B, Hkv, rep·Lb, Lb] and its
        future mask (None without ``causal``), made in place: at a
        7.9k-token block one such tensor is 4 GB."""
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()).mul_(self.scale)
        logits.add_(bb[:, None, None, :])
        if not self.causal:
            return logits, None
        q_pos, k_pos = _positions(self.me, self.src(s), self.Lb, self.rep, qf.device)
        future = k_pos[None, :] > q_pos[:, None]
        return logits.masked_fill_(future, MASKED), future


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kb, group, scale, causal, blocks):
        st = _RingState(q, k, group, scale, causal, blocks)
        kcur, vcur, bcur = k, v, kb
        if st.kernels:
            acc = lse_l = m = None
        else:
            qf = st.folded_q(q)
            rows = (st.B, st.Hkv, st.rep * st.Lb)
            m = torch.full(rows, MASKED, dtype=torch.float32, device=q.device)
            lse_l = torch.zeros(rows, dtype=torch.float32, device=q.device)
            acc = torch.zeros(rows + (st.D,), dtype=torch.float32, device=q.device)
        for s in range(st.n):
            if s:
                kcur, vcur, bcur = coll.ppermute_many([kcur, vcur, bcur], group)
            if st.skipped(s):
                continue
            if st.kernels:
                out_b, stats = fa.flash_fwd(q, _expand(kcur, st.rep), _expand(vcur, st.rep), bcur,
                                            scale, causal and s == 0)
                m_b, l_b = stats[0], stats[1].exp()
                if acc is None:  # the diagonal block comes first
                    m, lse_l, acc = m_b, l_b, out_b.float() * l_b[..., None]
                    continue
                m_new = torch.maximum(m, m_b)
                alpha, beta = (m - m_new).exp(), (m_b - m_new).exp() * l_b
                acc = acc * alpha[..., None] + out_b.float() * beta[..., None]
                lse_l, m = lse_l * alpha + beta, m_new
            else:  # JAX's step: the online softmax over the block
                logits, _ = st.plain_logits(qf, kcur, bcur, s)
                m_new = torch.maximum(m, logits.amax(-1))
                alpha = (m - m_new).exp()
                p = logits.sub_(m_new[..., None]).exp_()
                lse_l = lse_l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vcur.float())
                m = m_new
        out = acc / lse_l.clamp(min=1e-30)[..., None]
        # the rows' statistics in the flash kernels' form: (m, log l)
        stats = torch.stack([m, lse_l.clamp(min=1e-30).log()]).contiguous()
        out = out.reshape(st.B, st.H, st.Lb, st.D).to(q.dtype)
        ctx.save_for_backward(q, k, v, kb, out, stats)
        ctx.group, ctx.scale, ctx.causal, ctx.blocks = group, scale, causal, blocks
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kb, out, stats = ctx.saved_tensors
        group = ctx.group
        st = _RingState(q, k, group, ctx.scale, ctx.causal, ctx.blocks)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_acc = torch.zeros_like(dk_acc)
        if st.kernels:
            if not fa._aligned(dout):
                dout = dout.contiguous()
        else:
            qf = st.folded_q(q)
            dof = st.folded_q(dout)
            of = st.folded_q(out)
            delta = (dof * of).sum(-1)
            m, lse_l = stats[0], stats[1].exp()
            dqf = torch.zeros_like(qf)
        kcur, vcur, bcur = k, v, kb
        for s in range(st.n):
            if not st.skipped(s):
                if st.kernels:
                    kx, vx = _expand(kcur, st.rep), _expand(vcur, st.rep)
                    causal_b = ctx.causal and s == 0
                    dq_b, delta = fa.flash_dq(q, kx, vx, bcur, out, stats, dout, ctx.scale,
                                              causal_b)
                    dk_b, dv_b = fa.flash_dkv(q, kx, vx, bcur, stats, dout, delta, ctx.scale,
                                              causal_b)
                    dq += dq_b.float()
                    dk_acc += _fold(dk_b.float(), st.rep)
                    dv_acc += _fold(dv_b.float(), st.rep)
                else:  # the plain step's gradient, recomputed from the statistics
                    logits, future = st.plain_logits(qf, kcur, bcur, s)
                    p = logits.sub_(m[..., None]).exp_().div_(lse_l[..., None])
                    dv_acc += torch.einsum("bhqk,bhqd->bhkd", p, dof)
                    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vcur.float())
                    ds = dp.sub_(delta[..., None]).mul_(p)
                    del p
                    if future is not None:
                        ds.masked_fill_(future, 0.0)
                    dqf += torch.einsum("bhqk,bhkd->bhqd", ds, kcur.float()) * ctx.scale
                    dk_acc += torch.einsum("bhqk,bhqd->bhkd", ds, qf) * ctx.scale
            # a block's dK/dV travel with it; after the last step they are home
            if s < st.n - 1:
                kcur, vcur, bcur, dk_acc, dv_acc = coll.ppermute_many(
                    [kcur, vcur, bcur, dk_acc, dv_acc], group)
            else:
                dk_acc, dv_acc = coll.ppermute_many([dk_acc, dv_acc], group)
        if not st.kernels:
            dq = dqf.reshape(q.shape)
        return (dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)) + (None,) * 5


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   bias: Optional[torch.Tensor] = None, causal: bool = False,
                   scale: Optional[float] = None, blocks: str = "auto") -> torch.Tensor:
    """Exact attention with K/V blocks rotating around the ``seq`` ring, over
    this rank's slices q [B, H, L/P, D] and k, v [B, Hkv, L/P, D] (H a
    multiple of Hkv) with their key bias [B, L/P] (or [B, 1, 1, L/P]);
    returns this rank's slice of the output. ``blocks``: ``auto`` runs the
    flash kernels on CUDA tensors (bfloat16, D in (32, 64, 128); anything
    else raises) and the plain ring step on CPU tensors; ``plain`` the plain
    step anywhere (the reference ``chip_smoke.py`` holds the kernels
    against); ``flash`` the kernel route anywhere (on CPU tensors the
    kernels' plain versions, which is how the tests hold its merge)."""
    B, H, Lb, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != q.shape[2:] or H % k.shape[1]:
        raise ValueError(f"ring_attention takes q [B, H, L, D] and k, v [B, Hkv, L, D] with "
                         f"Hkv dividing H; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if blocks not in ("auto", "plain", "flash"):
        raise ValueError(f"blocks must be auto, plain or flash, got {blocks!r}")
    if q.is_cuda and blocks != "plain" and (D not in fa.HEAD_DIMS or q.dtype != torch.bfloat16):
        raise ValueError(f"ring_attention's kernels take bfloat16 with D in {fa.HEAD_DIMS}; "
                         f"got {q.dtype}, D={D}")
    kb = _kbias(bias, B, Lb, q.device)
    return _Ring.apply(q, k, v, kb, group, scale if scale is not None else D ** -0.5, causal,
                       blocks)


def sp_attention(mode: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                 bias: Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
    """``mode``'s attention over replicated q, k, v [B, H, L, D] (an encoder
    whose stream stays whole outside attention, as JAX's layout leaves it):
    L padded to the axis, this rank's slice attended, the output gathered
    and the padding sliced off."""
    n = coll.axis_size(group)
    q, k, v, kb, L = pad_seq_to_axis(q, k, v, bias, n)
    parts = [shard_seq(t, group, 2) for t in (q, k, v)]
    fn = ulysses_attention if mode == "ulysses" else ring_attention
    out = fn(*parts, group, bias=shard_seq(kb, group, 1), causal=causal)
    return gather_seq(out, group, 2)[:, :, :L]
