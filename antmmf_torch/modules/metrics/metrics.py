"""Batch metrics and the ``Metrics`` aggregator.

Port of the retrieval part of ``antmmf_tpu/modules/metrics/metrics.py``:
``mm_retrieval_recall`` (the rank of the diagonal of a text × video
similarity matrix; ``params.topk`` 1, 5, 10 or ``median-rank``), its
``mm_retrieval_recall@k`` and ``mm_retrieval_median_rank`` fronts and the
``global_retrieval_recall`` batch front. They run on the device with the
step and need no host sync. ``Metrics`` builds them from a model's
``metrics`` config; ``ModelShell.loss_fn`` reports them as ``metrics/*``.
The other metric types raise until they are ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch

from antmmf_torch.common.registry import registry

NOT_PORTED = ("accuracy", "topk_accuracy", "binary_f1")


class BaseMetric:
    def __init__(self, params: Optional[Mapping[str, Any]] = None):
        self.params = dict(params or {})

    def __call__(self, batch: Mapping, output: Mapping) -> Optional[torch.Tensor]:
        raise NotImplementedError


@registry.register_metric("mm_retrieval_recall")
@registry.register_metric("global_retrieval_recall")
class MMRetrievalRecall(BaseMetric):
    """R@topk of the diagonal: the share of rows whose positive has fewer
    than ``topk`` strictly greater entries; ``median-rank`` gives the median
    1-based rank (the mean of the two middle ranks for an even count)."""

    topk: Any = None

    def __call__(self, batch, output):
        sim = output.get("sim", output.get("l1_simi"))
        if sim is None:
            return None
        topk = self.topk if self.topk is not None else self.params.get("topk", 1)
        rank = (sim > torch.diagonal(sim)[:, None]).sum(dim=-1)
        if topk == "median-rank":
            return torch.quantile((rank + 1).float(), 0.5)
        return (rank < int(topk)).float().mean()


for _k in (1, 5, 10):
    registry.register_metric(f"mm_retrieval_recall@{_k}")(
        type(f"MMRetrievalRecall{_k}", (MMRetrievalRecall,), {"topk": _k}))
registry.register_metric("mm_retrieval_median_rank")(
    type("MMRetrievalMedianRank", (MMRetrievalRecall,), {"topk": "median-rank"}))


class Metrics:
    """The configured batch metrics, by name: ``[{type, name, params}, ...]``."""

    def __init__(self, metric_configs: Optional[List] = None):
        self.entries = []
        for cfg in metric_configs or []:
            if isinstance(cfg, str):
                cfg = {"type": cfg}
            if cfg["type"] in NOT_PORTED:
                raise NotImplementedError(f"metric {cfg['type']!r} is not ported yet; the "
                                          f"mm_retrieval_recall family is")
            cls = registry.get_metric_class(cfg["type"])
            self.entries.append((cfg.get("name", cfg["type"]), cls(cfg.get("params", {}))))

    def __call__(self, batch: Mapping, output: Mapping) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for name, fn in self.entries:
            val = fn(batch, output)
            if val is not None:
                out[name] = val
        return out
