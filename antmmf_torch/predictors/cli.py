"""Standalone serving CLI: one-shot and batch predictions from the shell.

Port of ``antmmf_tpu/predictors/cli.py:44-109``::

    python -m antmmf_torch.predictors.cli --config exp.yml \\
        [--model_dir dir] [--predictor base_predictor] [--device cpu] \\
        [--input req.json | --input -] [--batch reqs.jsonl] [--no_ckpt] \\
        [key.path value ...]

``--input`` takes one JSON request (a file, or ``-`` for stdin) and prints one
JSON result; ``--batch`` takes a jsonl file and prints one result per line
(one forward through ``BatchPredictor`` when the predictor has
``predict_batch``). ``--no_ckpt`` serves seeded random weights. ``--device``
picks the device (default ``cuda``, which must be present).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_request(path: str):
    if path == "-":
        return json.loads(sys.stdin.read())
    with open(path) as f:
        return json.load(f)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def build_predictor(argv=None):
    """Parse the CLI arguments and return (loaded predictor, parsed args)."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--predictor", default=None,
                   help="registry name; default from predictor_parameters")
    p.add_argument("--input", default=None, help="JSON request file or '-'")
    p.add_argument("--batch", default=None, help="jsonl file of requests")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; overrides predictor_parameters.device")
    p.add_argument("--no_ckpt", action="store_true")
    p.add_argument("opts", nargs="*", default=[],
                   help="dotted-path config overrides: key value [key value]")
    args = p.parse_args(argv)

    import antmmf_torch.predictors  # noqa: F401  (registers the predictors)
    from antmmf_torch.common.configuration import Configuration
    from antmmf_torch.common.registry import registry

    config = Configuration.from_file(args.config)
    if args.opts:
        config.override_with_opts(args.opts)
    pp = dict(config.get("predictor_parameters", None) or {})
    if args.model_dir:
        pp["model_dir"] = args.model_dir
    if args.device:
        pp["device"] = args.device
    name = args.predictor or pp.get("predictor", "base_predictor")
    cls = registry.get_predictor_class(name, default=None)
    if cls is None:
        raise SystemExit(f"Unknown predictor {name!r}")
    config["predictor_parameters"] = pp
    return cls(config).load(with_ckpt=not args.no_ckpt), args


def main(argv=None) -> None:
    predictor, args = build_predictor(argv)
    if args.batch:
        with open(args.batch) as f:
            reqs = [json.loads(line) for line in f if line.strip()]
        if hasattr(predictor, "predict_batch"):
            results = predictor.predict_batch(reqs)
        else:
            results = [predictor.predict(r) for r in reqs]
        for r in results:
            print(json.dumps(_jsonable(r)))
    else:
        print(json.dumps(_jsonable(predictor.predict(_load_request(args.input or "-")))))


if __name__ == "__main__":
    main()
