"""The serving block that ``m2_omni_7b.yml`` lacks.

The recipe is a training config and has no ``predictor_parameters``.
``serving_opts`` lays a ``unified_processor`` block over it for
``generation_predictor``, as command-line opts:

    python -m antmmf_torch.predictors.cli --config projects/m2_omni/configs/m2_omni_7b.yml \\
      --predictor generation_predictor --no_ckpt --input req.json \\
      $(python -c 'from antmmf_torch.predictors.m2_omni_serving import serving_opts; \\
                   print(*serving_opts())')
"""

from __future__ import annotations

import os
from typing import Any, List

from antmmf_torch.models.m2_omni import audio_token_count

M2_OMNI_7B = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "projects", "m2_omni", "configs", "m2_omni_7b.yml")
SERVING_SEQ_LEN, SERVING_PIXELS, AUDIO_FRAMES = 640, 448 * 448, 256


def serving_opts(**model: Any) -> List[str]:
    """The opts of the serving block (pass ``--config M2_OMNI_7B``): prompts
    of ``SERVING_SEQ_LEN`` tokens, images and frame pairs resized to
    ``SERVING_PIXELS`` (min = max), ``num_audio_tokens`` the tower's count
    at ``AUDIO_FRAMES`` fbank frames (64 for the conv tower), the patch ids
    the model's; then ``model``'s keys of ``model_attributes.m2_omni`` on top
    (presets, dtype, the audio tower)."""
    up = "predictor_parameters.unified_processor"
    tokens = audio_token_count(str(model.get("audio_tower", "conv")),
                               int(model.get("audio_compress", 3)), AUDIO_FRAMES)
    opts = [f"{up}.text.max_seq_length", str(SERVING_SEQ_LEN),
            f"{up}.audio.max_frames", str(AUDIO_FRAMES), f"{up}.num_audio_tokens", str(tokens)]
    for kind in ("image", "video"):
        opts += [f"{up}.{kind}.min_pixels", str(SERVING_PIXELS),
                 f"{up}.{kind}.max_pixels", str(SERVING_PIXELS)]
    for key, value in model.items():
        opts += [f"model_attributes.m2_omni.{key}", str(value)]
    return opts
