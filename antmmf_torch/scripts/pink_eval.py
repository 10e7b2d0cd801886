"""Pink evaluation harness: VQA-family and grounding-family benchmarks.

Port of ``antmmf_tpu/scripts/pink_eval.py``: the reference's per-dataset
eval scripts share one loop (prompt → ``generate`` → the task's scorer),
so this is one harness parameterised by ``--task`` (or a reference
benchmark's name, ``BENCHMARK_ALIASES``):

  vqa        VQA-protocol answer accuracy (min(#agreeing/3, 1))
  grounding  the first ``[x1,y1,x2,y2]`` parsed from the generation, IoU@0.5
  pointing   the parsed box's centre inside the ground-truth box
  mc         multiple choice: the option's letter or its text
  binary     yes / no
  caption    the generations only

Annotations are jsonl rows ``{"image": ..., "question": ..., "answer": str
| "answers": [str], "bbox": [x1,y1,x2,y2]?, "width"?, "height"?}``; images
are read with OpenCV from ``--image_dir`` (a missing one is black). The
scorers, ``score_rows``, ``BENCHMARK_ALIASES`` and
``build_benchmark_prompt`` are the JAX harness's, on the port's
``pink_processors`` and conversation templates. Decoding is the port's
``PinkModel.generate``: greedy, ``--num_beams``, ``--speculate`` GAMMA
(prompt-lookup speculation, greedy's tokens) or ``--do_sample`` with
``--top_p``, ``--temperature`` and ``--seed``. Weights come from
``--model_dir`` (a trainer's ``save_dir`` or a ``params.npz``, found as a
predictor finds them: ``common/checkpoint.find_weights``), else seeded
random weights (seed 0). The model runs on ``--device`` (default
``cuda``; ``cpu`` only when asked). Config overrides follow as ``key
value`` pairs. Prints the summary as one JSON line.

Usage::

    python -m antmmf_torch.scripts.pink_eval --config <cfg.yml> \
        --annotations val.jsonl --image_dir data/images --task grounding \
        [--model_dir save_dir] [--num_beams 3 | --speculate 4 | --do_sample] \
        [--device cpu|cuda] [key value ...]
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from antmmf_torch.datasets.processors.pink_processors import parse_boxes, serialize_box
from antmmf_torch.utils.conversation import build_prompt

# --- Official VQA-protocol text normalization -------------------------------
# Exact behavior of the VQAv2 evaluation API the reference vendors at
# prj/Pink/pink/eval/vqa_tools/vqa_eval.py:249-275 (processPunctuation +
# processDigitArticle). The tables below are the standard public VQA-eval
# data tables (Agrawal et al. COCO VQA API), required verbatim for
# protocol-identical accuracy numbers.
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
_MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_ARTICLES = frozenset(("a", "an", "the"))
# note: the upstream periodStrip regex carries a typo'd lookbehind
# ("(?!<=\d)" — a LOOKAHEAD for the literal "<=\d") so it strips every
# period; reproduced as-is for protocol-identical output.
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_VQA_PUNCT = [";", "/", "[", "]", '"', "{", "}", "(", ")", "=", "+",
              "\\", "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def process_punctuation(text: str) -> str:
    """vqa_eval.py:249-260 processPunctuation: a punct char glued to a word
    (or any digit,digit comma in the string) is deleted; a free-standing one
    becomes a space; then periods not followed by a digit are stripped."""
    out = text
    for p in _VQA_PUNCT:
        if (p + " " in text or " " + p in text) or (
                _COMMA_STRIP.search(text) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out)


def process_digit_article(text: str) -> str:
    """vqa_eval.py:261-275 processDigitArticle: lowercase, number words →
    digits, drop articles, then expand known contractions."""
    out = []
    for word in text.lower().split():
        word = _MANUAL_MAP.get(word, word)
        if word not in _ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in _CONTRACTIONS:
            out[i] = _CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(text: str) -> str:
    """Full VQA-protocol normalization of a generated answer
    (vqa_eval.py:211-216: newline/tab → space, strip, processPunctuation,
    processDigitArticle)."""
    text = text.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(text))


def vqa_score(prediction: str, answers: Sequence[str]) -> float:
    """Official VQAv2 per-question accuracy (vqa_eval.py:193-246): the
    prediction is fully normalized; ground-truth answers get punctuation
    normalization only (and only when annotators disagree); accuracy is the
    leave-one-annotator-out average of min(1, #matching others / 3).

    The multi-annotator path follows the official VQA API (vqa_tools/
    vqa_eval.py) verbatim — deliberately chosen over the slightly divergent
    per-benchmark script copies. With a single gt answer it degrades to
    exact match on FULLY-normalized strings on both sides, matching the
    reference single-answer scripts (eval_gqa.py:96-105 lowercases and
    normalizes the gt too — a raw gt would make e.g. vqa_score("two",
    ["two"]) == 0.0 since only the pred is number-mapped to "2")."""
    pred = normalize_answer(prediction)
    gt = [str(a).replace("\n", " ").replace("\t", " ").strip()
          for a in answers]
    if len(gt) == 1:
        return float(normalize_answer(gt[0]) == pred)
    if len(set(gt)) > 1:
        gt = [process_punctuation(a) for a in gt]
    accs = []
    for i in range(len(gt)):
        others = gt[:i] + gt[i + 1:]
        accs.append(min(1.0, sum(o == pred for o in others) / 3.0))
    return float(sum(accs) / len(accs))


def box_iou(a: Sequence[float], b: Sequence[float]) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    ub = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    return inter / max(ua + ub - inter, 1e-9)


def grounding_score(
    pred_text: str, gt_box: Sequence[float],
    width: float = 1.0, height: float = 1.0,
    iou_threshold: float = 0.5, expand2square: bool = True,
) -> float:
    """1.0 iff the FIRST box parsed from the generation has IoU ≥ threshold
    with the gt (acc@0.5, the refcoco/VG protocol of model_vg_base_batch)."""
    boxes = parse_boxes(pred_text, width, height, expand2square=expand2square)
    if len(boxes) == 0:
        return 0.0
    return float(box_iou(boxes[0], gt_box) >= iou_threshold)


def pointing_score(
    pred_text: str, gt_box: Sequence[float],
    width: float = 1.0, height: float = 1.0, expand2square: bool = True,
) -> float:
    """1.0 iff the center of the first parsed box falls inside the gt box
    (the pointing-QA protocol of model_pointingvqa_local)."""
    boxes = parse_boxes(pred_text, width, height, expand2square=expand2square)
    if len(boxes) == 0:
        return 0.0
    cx = (boxes[0][0] + boxes[0][2]) / 2.0
    cy = (boxes[0][1] + boxes[0][3]) / 2.0
    return float(gt_box[0] <= cx <= gt_box[2] and gt_box[1] <= cy <= gt_box[3])


def mc_score(pred: str, answer: str, options: Sequence[str]) -> float:
    """Multiple-choice accuracy (reference model_seed/iconqa/mmbench class):
    the prediction names the correct option letter or its text."""
    p = pred.strip().lower()
    ans = answer.strip().lower()
    letters = "abcdefgh"[: max(1, len(options))]
    if len(ans) == 1 and ans in letters:  # answer given as a letter
        idx = letters.index(ans)
        opt = options[idx].strip().lower() if idx < len(options) else ""
    else:
        opt = ans
        idx = next((i for i, o in enumerate(options)
                    if o.strip().lower() == ans), -1)
    first = p.split(".")[0].split(")")[0].strip()
    if idx >= 0 and first == letters[idx]:
        return 1.0
    return 1.0 if opt and opt in p else 0.0


def binary_score(pred: str, answer) -> float:
    """True/false accuracy (reference model_vsr.py class)."""
    p = pred.strip().lower()
    truthy = {"true", "yes", "1"}
    want = (str(answer).strip().lower() in truthy) if not isinstance(
        answer, bool) else answer
    got = any(t in p.split()[:3] for t in truthy) if p else False
    falsy = {"false", "no", "0"}
    if any(t in p.split()[:3] for t in falsy):
        got = False
    return float(got == want)


def score_rows(
    rows: Sequence[Dict], predictions: Sequence[str], task: str,
) -> Dict[str, float]:
    """Aggregate per-row scores → summary dict (pure; unit-testable).

    Task families mirror the reference eval scripts
    (prj/Pink/pink/eval/model_*.py): vqa/gqa/okvqa (open answer match),
    grounding (IoU@0.5), pointing (point-in-box), mc (seed/iconqa/mmbench
    multiple-choice), binary (vsr true/false), caption (dump only)."""
    scores: List[float] = []
    for row, pred in zip(rows, predictions):
        if task in ("vqa", "gqa", "okvqa"):
            answers = row.get("answers") or [row["answer"]]
            scores.append(vqa_score(pred, answers))
        elif task == "mc":
            scores.append(mc_score(pred, str(row["answer"]),
                                   row.get("options", [])))
        elif task == "binary":
            scores.append(binary_score(pred, row["answer"]))
        elif task == "caption":
            continue
        else:
            fn = grounding_score if task == "grounding" else pointing_score
            scores.append(fn(pred, row["bbox"],
                             float(row.get("width", 1.0)),
                             float(row.get("height", 1.0))))
    key = {"vqa": "vqa_accuracy", "gqa": "gqa_accuracy",
           "okvqa": "okvqa_accuracy", "grounding": "acc@0.5",
           "pointing": "pointing_acc", "mc": "mc_accuracy",
           "binary": "binary_accuracy", "caption": "n_dumped"}[task]
    if task == "caption":
        return {key: float(len(predictions)), "n": float(len(predictions))}
    return {key: float(np.mean(scores)) * 100.0 if scores else 0.0,
            "n": float(len(scores))}


# Every reference eval script (prj/Pink/pink/eval/model_*.py) resolves to
# one of the scorer families above; ``--task <script-name>`` accepts the
# reference benchmark names directly.
BENCHMARK_ALIASES = {
    "vqav2": "vqa",                    # model_vqav2.py (VQA soft-match)
    "iconqa": "mc",                    # model_iconqa.py (letter choice)
    "seed": "mc",                      # model_seed.py (letter choice)
    "v7wgrounding": "mc",              # model_v7wgrounding.py (letter over
                                       # shuffled candidate boxes)
    "vsr": "binary",                   # model_vsr.py (yes/no)
    "vg": "grounding",                 # model_vg_base_batch.py (IoU@0.5)
    "object365": "grounding",          # model_object365.py (IoU@0.5)
    "pointingvqa_local": "pointing",   # model_pointingvqa_local.py
    "pointingvqa_looktwice": "pointing",  # model_pointingvqa_looktwice.py
}

# Instruction-marker tokens (reference pink/model/pink.py:35-51): questions,
# option blocks, referring descriptions and serialized locations are wrapped
# in typed tags that Pink's instruction tuning expects verbatim.
BEGIN_QUESTION, END_QUESTION = "<qes>", "</qes>"
BEGIN_OPTIONS, END_OPTIONS = "<opt>", "</opt>"
BEGIN_DESCRIPTION, END_DESCRIPTION = "<des>", "</des>"
BEGIN_LOC, END_LOC = "<loc>", "</loc>"

# Instruction pools in the style of the reference Templates.py families
# (QuestionAnswer:294, ChoiceQuestionAnswer:833, VisualGrounding:1,
# GroundingCaption:166 — pools of ~50 paraphrases with `<question>`,
# `<option>`, `<expr>`, `<objs>`, `<image>` placeholders). The eval scripts
# `random.choice` a paraphrase per row; here the pools are small fresh
# paraphrases with the SAME placeholder/tag structure and rows cycle through
# them deterministically (reproducible evals).
QUESTION_ANSWER_TEMPLATES = (
    "Please look at the image <image> and give a direct answer to my "
    "question: <question>",
    "Answer the question <question> briefly, based on the image <image>.",
    "Consider the image <image> and respond concisely to: <question>",
)
CHOICE_QUESTION_TEMPLATES = (
    "Look at the image <image> and pick the correct answer to <question> "
    "from the options below\n<option>.",
    "Based on the image <image>, select the best answer for the question: "
    "<question> from these options\n<option>.",
)
VISUAL_GROUNDING_EVAL_TEMPLATES = (
    "Where is <expr>? answer in [x0,y0,x1,y1] format.",
    "What are the coordinates of <expr> in the image?",
    "Locate <expr> in the image and give its bounding-box coordinates.",
)
GROUNDING_CAPTION_TEMPLATES = (
    "Can you describe the region <objs> of the image <image>?",
    "Give a short description of the area <objs> in the image <image>.",
)

_OPTION_LETTERS = "ABCDEFGH"


def _cycle(pool: Sequence[str], idx: int) -> str:
    return pool[idx % len(pool)]


def _format_options(options: Sequence[str], idx_to_loc: bool = False) -> str:
    """'A. opt\nB. opt' block, tag-wrapped (reference model_seed.py:227-231;
    v7w wraps each candidate box in <loc></loc>, model_v7wgrounding.py:184-188)."""
    body = ""
    for i, opt in enumerate(options):
        o = f"{BEGIN_LOC}{opt}{END_LOC}" if idx_to_loc else str(opt)
        body += f"{_OPTION_LETTERS[i]}. {o}\n"
    return BEGIN_OPTIONS + body.rstrip("\n").rstrip(" ") + END_OPTIONS


def build_benchmark_prompt(benchmark: str, row: Dict, idx: int = 0,
                           template: str = "vicuna_v1") -> str:
    """Render row → the per-benchmark instruction the reference eval script
    builds, then wrap it in the conversation template.

    Mirrors (structure, tags and task hints — paraphrase pools are fresh):
      vqav2/gqa/okvqa  QuestionAnswer template, <question> → <qes>q</qes>
                       (model_vqav2.py:406-408, model_gqa.py:223-225)
      vsr              question + " Is it correct? Answer with Yes or No."
                       through QuestionAnswer (model_vsr.py:175-178)
      iconqa/seed      ChoiceQuestionAnswer + lettered <opt> block
                       (model_seed.py:224-231)
      v7wgrounding     ChoiceQuestionAnswer, options are <loc>-wrapped
                       candidate boxes (model_v7wgrounding.py:181-188)
      vg               VisualGrounding, <expr> → <des>expr</des>
                       (model_vg_base_batch.py:54-56)
      object365        GroundingCaption, <objs> → <loc>[box]</loc>
                       (model_object365.py:324-326)
      pointingvqa_*    "{question} <loc>[x,y]</loc>" / bbox variant, raw
                       1/width scaling, no expand2square
                       (model_pointingvqa_local.py:180-190)

    Rows reuse the generic jsonl schema (`question`, `options`, `bbox`,
    `point`, `expr`/`caption`, `width`, `height`).
    """
    q = str(row.get("question", ""))
    if benchmark in ("vqa", "vqav2", "gqa", "okvqa", "vsr"):
        if benchmark == "vsr":
            q = (str(row.get("caption", q))
                 + " Is it correct? Answer with Yes or No.")
        instr = _cycle(QUESTION_ANSWER_TEMPLATES, idx).replace(" <image>", "")
        instr = instr.replace("<question>",
                              BEGIN_QUESTION + q + END_QUESTION)
    elif benchmark in ("mc", "iconqa", "seed", "v7wgrounding"):
        opts = list(row.get("options", []))
        if benchmark == "v7wgrounding" and opts and not isinstance(
                opts[0], str):  # candidate boxes given as [x1,y1,x2,y2]
            w, h = float(row.get("width", 1.0)), float(row.get("height", 1.0))
            opts = ["[{:.3f},{:.3f},{:.3f},{:.3f}]".format(
                b[0] / w, b[1] / h, b[2] / w, b[3] / h) for b in opts]
        instr = _cycle(CHOICE_QUESTION_TEMPLATES, idx).replace(" <image>", "")
        instr = instr.replace("<question>",
                              BEGIN_QUESTION + q + END_QUESTION)
        instr = instr.replace("<option>", _format_options(
            opts, idx_to_loc=benchmark == "v7wgrounding"))
    elif benchmark in ("grounding", "vg"):
        expr = str(row.get("expr", row.get("caption", q)))
        instr = _cycle(VISUAL_GROUNDING_EVAL_TEMPLATES, idx).replace(
            " <image>", "")
        instr = instr.replace(
            "<expr>", BEGIN_DESCRIPTION + expr + END_DESCRIPTION)
    elif benchmark in ("object365", "caption"):
        box = row.get("bbox", (0.0, 0.0, 1.0, 1.0))
        loc = serialize_box(box, float(row.get("width", 1.0)),
                            float(row.get("height", 1.0)),
                            expand2square=False)
        instr = _cycle(GROUNDING_CAPTION_TEMPLATES, idx).replace(
            " <image>", "")
        instr = instr.replace("<objs>", loc)
    elif benchmark in ("pointing", "pointingvqa_local",
                       "pointingvqa_looktwice"):
        w, h = float(row.get("width", 1.0)), float(row.get("height", 1.0))
        if "point" in row:
            px, py = row["point"]
            loc = "[{:.3f},{:.3f}]".format(px / w, py / h)
        else:
            b = row["bbox"]
            loc = "[{:.3f},{:.3f},{:.3f},{:.3f}]".format(
                b[0] / w, b[1] / h, b[2] / w, b[3] / h)
        instr = f"{q} {BEGIN_LOC}{loc}{END_LOC}"
    else:
        instr = q
    return build_prompt(instr, template)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--annotations", required=True)
    parser.add_argument("--image_dir", required=True)
    parser.add_argument("--task", default="vqa",
                        choices=("vqa", "gqa", "okvqa", "grounding", "pointing", "mc", "binary",
                                 "caption") + tuple(BENCHMARK_ALIASES))
    parser.add_argument("--model_dir", default=None,
                        help="a trainer's save_dir or a directory with params.npz")
    parser.add_argument("--vocab_file", default="tests/data/vocabs/"
                                                "bert-base-uncased_30522_vocab.txt")
    parser.add_argument("--template", default="vicuna_v1")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--max_prompt_len", type=int, default=64)
    parser.add_argument("--max_new_tokens", type=int, default=24)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--speculate", type=int, default=0, metavar="GAMMA",
                        help="prompt-lookup speculative greedy decoding (greedy's tokens)")
    parser.add_argument("--do_sample", action="store_true")
    parser.add_argument("--top_p", type=float, default=0.9)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0, help="the sampling draw's seed")
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out", default=None, help="optional jsonl of per-row predictions")
    parser.add_argument("opts", nargs="*", default=[],
                        help="dotted-path config overrides: key value [key value]")
    return parser.parse_args(argv)


def load_model(args: argparse.Namespace):
    """The config's model on ``args.device``: ``--model_dir``'s weights, or
    seeded random weights."""
    from antmmf_torch.common.build import build_config
    from antmmf_torch.common.checkpoint import find_weights, load_weights
    from antmmf_torch.models.base_model import build_model

    cfg = build_config(args.config, opts=args.opts or None)
    shell = build_model(cfg, device=args.device)
    shell.init(on_device=bool(args.model_dir))
    if args.model_dir:
        load_weights(shell.module, find_weights(args.model_dir))
    return shell


def main(argv: Optional[Sequence[str]] = None, shell=None) -> Dict[str, float]:
    """Evaluate; ``shell`` serves an already loaded model in place of the
    config's. Returns the printed summary."""
    import torch

    from antmmf_torch.datasets.processors.image_processors import NormalizedImageProcessor
    from antmmf_torch.predictors.caption_predictor import ids_to_caption
    from antmmf_torch.utils.tokenization import BertTokenizer

    args = parse_args(argv)
    shell = shell or load_model(args)
    tok = BertTokenizer(args.vocab_file)
    proc = NormalizedImageProcessor({"size": args.image_size, "resize": args.image_size + 32})
    with open(args.annotations) as f:
        rows = [json.loads(line) for line in f if line.strip()]

    import cv2

    def tokenize(text: str):
        ids = tok.convert_tokens_to_ids(["[CLS]"] + tok.tokenize(text)[: args.max_prompt_len - 1])
        out = np.zeros(args.max_prompt_len, np.int64)
        msk = np.zeros(args.max_prompt_len, np.int64)
        out[: len(ids)] = ids
        msk[: len(ids)] = 1
        return out, msk

    predictions: List[str] = []
    bs = args.batch_size
    for s in range(0, len(rows), bs):
        chunk = rows[s: s + bs]
        ids, masks, imgs = [], [], []
        for ri, r in enumerate(chunk):
            i, m = tokenize(build_benchmark_prompt(args.task, r, idx=s + ri,
                                                   template=args.template))
            ids.append(i)
            masks.append(m)
            img = cv2.imread(os.path.join(args.image_dir, r["image"]))
            imgs.append(proc.transform_array(
                img[:, :, ::-1] if img is not None
                else np.zeros((args.image_size, args.image_size, 3), np.uint8)))
        pad = bs - len(chunk)  # the last batch repeats its last row
        batch = shell.to_device({"input_ids": np.stack(ids + [ids[-1]] * pad),
                                 "input_mask": np.stack(masks + [masks[-1]] * pad),
                                 "image_data": np.stack(imgs + [imgs[-1]] * pad)})
        with torch.inference_mode():
            tokens, lens = shell.module.generate(
                batch, max_length=args.max_new_tokens, num_beams=args.num_beams,
                speculative=args.speculate, do_sample=args.do_sample, top_p=args.top_p,
                temperature=args.temperature, seed=args.seed)
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        for bi in range(len(chunk)):
            predictions.append(ids_to_caption(
                tok, tokens[bi, lens[bi]: lens[bi] + args.max_new_tokens]))

    summary = score_rows(rows, predictions, BENCHMARK_ALIASES.get(args.task, args.task))
    if args.out:
        with open(args.out, "w") as f:
            for row, pred in zip(rows, predictions):
                f.write(json.dumps({**row, "prediction": pred}) + "\n")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
