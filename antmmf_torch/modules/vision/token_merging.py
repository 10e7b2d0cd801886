"""Token Merging (ToMe, arXiv:2210.09461) between ViT blocks.

Port of ``antmmf_tpu/modules/vision/token_merging.py``: bipartite soft
matching merges the ``r`` most similar even-index tokens into their best
odd-index match by size-weighted averaging. The CLS token (index 0) is
protected by a -inf match score. The JAX ``vmap`` over samples is a batch
dimension here: ``gather`` for the selections, ``index_add_`` over the
flattened (sample, token) index for the merge.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b, i]] for t [B, L] or [B, L, C] and idx [B, n]."""
    if t.dim() == 2:
        return torch.gather(t, 1, idx)
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def tome_merge(x: torch.Tensor, size: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge ``r`` tokens per sample: ([B, L, C], [B, L]) → ([B, L-r, C], [B, L-r])."""
    B, L, C = x.shape
    a, b = x[:, 0::2], x[:, 1::2]
    sa, sb = size[:, 0::2], size[:, 1::2]
    La, Lb = a.shape[1], b.shape[1]
    r = min(int(r), La - 1, Lb)  # the CLS token never merges
    if r <= 0:
        return x, size

    metric = x.float()
    metric = metric / (torch.linalg.vector_norm(metric, dim=-1, keepdim=True) + 1e-6)
    scores = metric[:, 0::2] @ metric[:, 1::2].transpose(1, 2)  # [B, La, Lb]
    scores[:, 0, :] = float("-inf")

    node_max, node_idx = scores.max(dim=-1)                     # [B, La]
    order = torch.argsort(-node_max, dim=1, stable=True)        # as jnp.argsort
    merged_src = order[:, :r]                                   # most-similar evens
    kept_src = torch.sort(order[:, r:], dim=1).values           # original order
    dst = torch.gather(node_idx, 1, merged_src)                 # [B, r]

    sa_m = _take(sa, merged_src)
    contrib = _take(a.float(), merged_src) * sa_m[..., None]
    flat_dst = (dst + torch.arange(B, device=x.device)[:, None] * Lb).reshape(-1)
    num = (b.float() * sb[..., None]).reshape(B * Lb, C)
    num = num.index_add(0, flat_dst, contrib.reshape(B * r, C)).reshape(B, Lb, C)
    den = sb.reshape(-1).index_add(0, flat_dst, sa_m.reshape(-1)).reshape(B, Lb)
    merged_b = (num / den[..., None]).to(x.dtype)
    out = torch.cat([_take(a, kept_src), merged_b], dim=1)
    sizes = torch.cat([_take(sa, kept_src), den], dim=1)
    return out, sizes
