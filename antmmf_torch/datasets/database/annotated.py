"""Annotation database: jsonl / json / npy / csv / tsv annotation files.

Own copy of ``antmmf_tpu/datasets/database/annotated.py``'s
``AnnotatedDatabase``: index-addressable records from a jsonl file, a
directory of jsonl shards, json (a list, or one under ``annotations``,
``data`` or ``samples``), npy imdb dumps (with metadata, or a legacy header
row) and csv/tsv tables, with the answers → label normalisation of
``preprocess_item``. ``DetectionCOCOAnnotated`` is not ported.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from typing import Any, Dict, List, Mapping

import numpy as np


class AnnotatedDatabase:
    def __init__(self, annotation_path: str, anno_type: str = "normal"):
        self.annotation_path = annotation_path
        self.anno_type = anno_type
        self.metadata: Dict[str, Any] = {}
        self.start_idx = 0
        self.data: List[Dict[str, Any]] = self._load(annotation_path)

    def _rows(self, path: str) -> List[Dict[str, Any]]:
        if os.path.isdir(path):  # directory of jsonl shards (ref :72)
            rows: List[Dict[str, Any]] = []
            for shard in sorted(glob.glob(os.path.join(path, "*.jsonl"))):
                with open(shard, encoding="utf-8") as f:
                    rows.extend(json.loads(line) for line in f if line.strip())
            return rows
        if path.endswith(".jsonl"):
            with open(path, encoding="utf-8") as f:
                return [json.loads(line) for line in f if line.strip()]
        if path.endswith(".json"):
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
            if isinstance(data, Mapping):  # {"annotations": [...]} style
                for key in ("annotations", "data", "samples"):
                    if key in data:
                        data = data[key]
                        break
            return list(data)
        if path.endswith(".npy"):
            db = np.load(path, allow_pickle=True)
            if db.ndim == 0 and isinstance(db.item(), dict):  # imdb dump
                item = db.item()
                self.metadata = item.get("metadata", {})
                return list(item.get("data", []))
            rows = db.tolist()
            # legacy imdb: header row carries metadata (ref :143-147)
            if rows and isinstance(rows[0], dict) and "image_id" not in rows[0]:
                self.start_idx = 1
            return rows
        if path.endswith((".csv", ".tsv")):
            delim = "\t" if path.endswith(".tsv") else ","
            with open(path, encoding="utf-8", newline="") as f:
                reader = csv.DictReader(f, delimiter=delim)
                self.metadata = list(reader.fieldnames or [])
                return [dict(r) for r in reader]
        raise ValueError(f"Unsupported annotation format: {path!r}")

    def _load(self, path: str) -> List[Dict[str, Any]]:
        if isinstance(path, (list, tuple)):
            assert len(path) == 1, "only one annotation path supported"
            path = path[0]
        if not os.path.exists(path):
            raise FileNotFoundError(f"Annotation file not found: {path!r}")
        rows = self._rows(path)
        keep = self.start_idx
        out = [self.process_annotation(r) for r in rows[keep:]]
        self.start_idx = 0  # rows already sliced
        return out

    def process_annotation(self, annotation: Dict[str, Any]) -> Dict[str, Any]:
        """Hook for subclasses to normalise records."""
        return annotation

    def preprocess_item(self, item: Dict[str, Any]) -> Dict[str, Any]:
        """Answers → label normalization for legacy imdbs (ref :159-175)."""
        if isinstance(item, dict) and "answers" not in item:
            if "all_answers" in item and "valid_answers" not in item:
                item["answers"] = item["all_answers"]
            if "valid_answers" in item:
                item["answers"] = item["valid_answers"]
        if isinstance(item, dict) and item.get("answers"):
            if item["answers"][-1] == "<copy>":
                item["answers"] = item["answers"][:-1]
            item["label"] = item["answers"]
        return item

    def get_version(self):
        return self.metadata.get("version") \
            if isinstance(self.metadata, dict) else None

    def __len__(self) -> int:
        return len(self.data) - self.start_idx

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.preprocess_item(self.data[self.start_idx + idx])
