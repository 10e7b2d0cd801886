"""Standalone serving CLI: one-shot and batch predictions from the shell.

Port of ``antmmf_tpu/predictors/cli.py:44-109``::

    python -m antmmf_torch.predictors.cli --config exp.yml \\
        [--model_dir dir] [--predictor base_predictor] [--device cpu] \\
        [--input req.json | --input -] [--batch reqs.jsonl] [--no_ckpt] \\
        [--engine reqs.jsonl [--slots 8] [--step_tokens 8] [--max_new 32]] \\
        [key.path value ...]

``--input`` takes one JSON request (a file, or ``-`` for stdin) and prints one
JSON result; ``--batch`` takes a jsonl file and prints one result per line
(one forward through ``BatchPredictor`` when the predictor has
``predict_batch``). ``--engine`` serves a jsonl file of generation requests
(``{"id"?, "input_ids", "max_new"?, "deadline_s"?, "stop"?, "do_sample"?,
"temperature"?, "top_p"?, "seed"?, "session"?, "image"?}``) through the
continuous-batching engine on the config's Pink or M2-omni model and prints
one JSON line a request (``id``, ``tokens``, ``evicted``, ``latency_s``) and
a ``stats`` line; an ``image`` is a path read with OpenCV. ``--no_ckpt``
serves seeded random weights; otherwise ``--model_dir`` (or
``predictor_parameters.model_dir``) is loaded as the predictors load it.
``--device`` picks the device (default ``cuda``, which must be present).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Mapping

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


def parse(argv=None):
    """(parsed arguments, the configuration with its ``predictor_parameters``
    overridden by them, the predictor class)."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--predictor", default=None,
                   help="registry name; default from predictor_parameters")
    p.add_argument("--input", default=None, help="JSON request file or '-'")
    p.add_argument("--batch", default=None, help="jsonl file of requests")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; overrides predictor_parameters.device")
    p.add_argument("--engine", default=None, metavar="REQS_JSONL",
                   help="serve generation requests through the continuous-batching engine")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--step_tokens", type=int, default=8)
    p.add_argument("--max_new", type=int, default=32)
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
    return args, config, cls


def build_predictor(argv=None):
    """Parse the CLI arguments and return (loaded predictor, parsed args)."""
    args, config, cls = parse(argv)
    return cls(config).load(with_ckpt=not args.no_ckpt), args


def _engine_request(i: int, r: Mapping[str, Any], image_size: int):
    """(id, engine request) of one jsonl row; an ``image`` path is read with
    OpenCV, resized to the model's size and scaled to [0, 1]."""
    ids = np.asarray(r["input_ids"], np.int64)
    d = {"input_ids": ids, "input_mask": np.ones(len(ids), np.int64)}
    for k in ("max_new", "deadline_s", "stop", "do_sample", "temperature", "top_p", "seed",
              "session"):
        if k in r:
            d[k] = r[k]
    if r.get("image"):
        from antmmf_torch.datasets.processors import image_processors as ip

        if ip.cv2 is None:
            raise RuntimeError(f"reading the image {r['image']!r} needs OpenCV (cv2)")
        bgr = ip.cv2.imread(r["image"], ip.cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(f"cannot read image {r['image']!r}")
        img = ip.resize_image(bgr[:, :, ::-1].copy(), (image_size, image_size))
        d["image_data"] = img.astype(np.float32) / 255.0
    return r.get("id", f"req{i}"), d


def serve_engine(config, args) -> None:
    """``--engine``: the config's model (seeded, or loaded from the model
    directory), its engine adapter, every request through the slot pool; one
    JSON line a request, then the stats."""
    import time

    from antmmf_torch.common.checkpoint import find_weights, load_weights
    from antmmf_torch.models.base_model import build_model
    from antmmf_torch.predictors.serving_engine import (
        ContinuousBatchingEngine,
        M2OmniAdapter,
        PinkAdapter,
    )

    with open(args.engine) as f:
        reqs = [json.loads(line) for line in f if line.strip()]
    if not reqs:
        raise SystemExit("no requests in --engine file")
    pp = config["predictor_parameters"]
    shell = build_model(config, device=pp.get("device", "cuda"))
    model_dir = pp.get("model_dir")
    with_ckpt = not args.no_ckpt and bool(model_dir)
    shell.init(on_device=with_ckpt or bool(pp.get("init_on_device", False)))
    if with_ckpt:
        load_weights(shell.module, find_weights(model_dir))
    model = shell.module
    size = int(dict(list(config["model_attributes"].values())[0]).get("image_size", 224))
    requests = [_engine_request(i, r, size) for i, r in enumerate(reqs)]
    adapter = (M2OmniAdapter if type(model).__name__ == "M2Omni" else PinkAdapter)(
        model, max_prompt_len=max(len(r["input_ids"]) for r in reqs),
        max_new_tokens=args.max_new, has_image=any("image" in r for r in reqs))
    engine = ContinuousBatchingEngine(adapter, slots=args.slots, max_new_tokens=args.max_new,
                                      eos_id=int(pp.get("eos_id", -1)),
                                      step_tokens=args.step_tokens)
    t0 = time.perf_counter()
    res = engine.run(requests)
    for rid, toks in res["outputs"].items():
        print(json.dumps({"id": rid, "tokens": [int(t) for t in toks],
                          "evicted": rid in res["evicted"],
                          "latency_s": round(engine._latency.get(rid, 0.0), 4)}))
    print(json.dumps({"stats": {k: (round(v, 4) if isinstance(v, float) else v)
                                for k, v in res.items()
                                if k not in ("outputs", "cancelled", "evicted")},
                      "wall_s": round(time.perf_counter() - t0, 3)}))


def main(argv=None) -> None:
    args, config, cls = parse(argv)
    if args.engine:
        serve_engine(config, args)
        return
    predictor = cls(config).load(with_ckpt=not args.no_ckpt)
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
