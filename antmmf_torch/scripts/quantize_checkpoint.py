"""Quantise a saved model into an int8 serving artifact.

Port of ``antmmf_tpu/scripts/quantize_checkpoint.py``::

    python -m antmmf_torch.scripts.quantize_checkpoint --model_dir save_dir/ \
        --out save_dir/model_int8.pkl [--config cfg.yml] [--min_size 4096] \
        [--exclude_regex "(norm|embed|logit_scale)"] [key value ...]

``--model_dir`` is a trainer's ``save_dir`` (its ``config.yaml`` builds
the model) or a directory with a ``params.npz`` (then ``--config`` names
the model's config); the weights are found as a predictor finds them
(``common/checkpoint.find_weights``). The artifact is
``predictors/quantization.save_quantized``'s: per-output-channel symmetric
int8 records of the large kernels, the rest as it is, in the JAX package's
layout and pickle, so its ``load_quantized`` reads it too. Prints one JSON
line: the source, the artifact, the kernels quantised and kept, and the
sizes in MB.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--config", default=None,
                   help="the model's config; default: model_dir/config.yaml")
    p.add_argument("--out", required=True)
    p.add_argument("--min_size", type=int, default=4096)
    p.add_argument("--exclude_regex", default=r"(norm|embed|logit_scale)")
    p.add_argument("opts", nargs="*", default=[],
                   help="dotted-path config overrides: key value [key value]")
    args = p.parse_args(argv)

    from antmmf_torch.common.build import build_config
    from antmmf_torch.common.checkpoint import find_weights, load_weights
    from antmmf_torch.models.base_model import build_model
    from antmmf_torch.predictors.quantization import save_quantized
    from antmmf_torch.utils.weights import export_flax_params

    config = args.config or os.path.join(args.model_dir, "config.yaml")
    if not os.path.exists(config):
        raise SystemExit(f"no config: {config!r} does not exist; pass --config")
    source = find_weights(args.model_dir)
    shell = build_model(build_config(config, opts=args.opts or None), device="cpu")
    load_weights(shell.module, source)
    stats = save_quantized({"params": export_flax_params(shell.module)}, args.out,
                           min_size=args.min_size, exclude_regex=args.exclude_regex)
    summary = {"source": source, "out": args.out, "quantized_kernels": stats["quantized"],
               "kept_fp32": stats["kept"], "mb_before": round(stats["bytes_before"] / 1e6, 1),
               "mb_artifact": round(os.path.getsize(args.out) / 1e6, 1)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
