"""The global-batch contrastive loss in row chunks.

Port of ``antmmf_tpu/parallel/contrastive.py`` (M2-Encoder's grouped
aggregation): the InfoNCE of N rows against N columns is summed chunk by
chunk of rows, each chunk's [chunk, N] logits made in the forward and made
again in the backward (``torch.utils.checkpoint``), so the peak is
O(chunk·N) instead of O(N²). The last chunk may be short.
"""

from __future__ import annotations

from typing import Union

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_loss(rows: torch.Tensor, cols: torch.Tensor, offset: int,
                scale: torch.Tensor) -> torch.Tensor:
    """Σ over a [C, D] chunk of (logsumexp − the positive logit), the
    positive of row i being column offset + i."""
    logits = (rows @ cols.T) * scale
    idx = torch.arange(rows.shape[0], device=rows.device) + offset
    pos = logits.gather(1, idx[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - pos).sum()


def chunked_infonce(rows: torch.Tensor, cols: torch.Tensor,
                    scale: Union[torch.Tensor, float] = 1.0,
                    chunk_size: int = 1024) -> torch.Tensor:
    """−mean_i log softmax(rows_i · colsᵀ · scale)_i, in fp32."""
    n = rows.shape[0]
    rows, cols = rows.float(), cols.float()
    scale = torch.as_tensor(scale, dtype=torch.float32, device=rows.device)
    total = rows.new_zeros(())
    for start in range(0, n, min(chunk_size, n)):
        chunk = rows[start:start + chunk_size]
        total = total + checkpoint(_chunk_loss, chunk, cols, start, scale,
                                   use_reentrant=False)
    return total / n


def chunked_symmetric_infonce(text: torch.Tensor, video: torch.Tensor,
                              scale: Union[torch.Tensor, float] = 1.0,
                              chunk_size: int = 1024) -> torch.Tensor:
    """(t2v + v2t) / 2 without the whole [N, N] matrix."""
    return 0.5 * (chunked_infonce(text, video, scale, chunk_size)
                  + chunked_infonce(video, text, scale, chunk_size))
