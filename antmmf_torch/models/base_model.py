"""Model building and the model shell.

Port of ``antmmf_tpu/models/base_model.py:61-190``: ``build_model`` resolves
``model_attributes.<name>`` through the registry, builds the module on its
device and wraps it in a ``ModelShell``. ``apply`` is the online-serving
forward (under ``torch.inference_mode``, losses dropped); ``loss_fn`` is the
training surface: the total is the sum of the means of the model's losses,
with ``losses/*``, ``metrics/*`` (the model config's ``metrics``, computed
on the device without a host sync) and ``total_loss`` scalars.
Config-declared losses (the registry's ``Losses``) raise until they are
ported.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from antmmf_torch.common.configuration import convert_to_config
from antmmf_torch.common.registry import registry
from antmmf_torch.modules.layers import init_weights
from antmmf_torch.modules.metrics.metrics import Metrics


def resolve_device(device: Optional[str] = None) -> torch.device:
    """The device to run on: CUDA unless the caller asks for another. Without
    CUDA a CUDA request raises; it never turns into a CPU run."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (CLI: --device cpu) "
                           "to run on the CPU")
    return device


class ModelShell:
    """A built model on its device, with the serving forward and the loss."""

    def __init__(self, module: nn.Module, device: torch.device,
                 metrics: Optional[Metrics] = None):
        self.module = module.eval()
        self.device = device
        self.metrics = metrics or Metrics([])
        # a model that draws training randomness takes the trainer's generator
        self.takes_generator = "generator" in inspect.signature(module.forward).parameters

    def init(self, seed: int = 0, on_device: bool = False) -> None:
        """Seeded random weights (flax's default initializers), drawn on the
        CPU, so that every device gets the same values from a seed, or with
        ``on_device`` on the module's device (other values, in a fraction of
        the time at billions of parameters)."""
        device = self.device if on_device else "cpu"
        init_weights(self.module, torch.Generator(device=device).manual_seed(seed))

    def to_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """A batch of arrays (numpy or tensors) as tensors on the device."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def apply(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Serving forward on a batch moved to the device; as the JAX online-
        serving shell, the model's losses are dropped."""
        with torch.inference_mode():
            out = dict(self.module(self.to_device(batch)))
        out.pop("losses", None)
        return out

    def loss_fn(self, batch: Mapping[str, Any], deterministic: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]:
        """(total, (output, scalars)) with gradients enabled: total is the sum
        of the means of ``output["losses"]``; ``output["metrics"]`` holds the
        model's metrics and the config's. ``generator`` reaches a model
        whose forward takes one (its training draws)."""
        batch = self.to_device(batch)
        kw = {"generator": generator} if self.takes_generator else {}
        output = dict(self.module(batch, deterministic=deterministic, **kw))
        losses = output.get("losses", {})
        total = (sum(v.mean() for v in losses.values()) if losses
                 else torch.zeros((), device=self.device))
        with torch.no_grad():
            output["metrics"] = {**output.get("metrics", {}), **self.metrics(batch, output)}
        scalars = {f"losses/{k}": v.detach().mean() for k, v in losses.items()}
        scalars.update({f"metrics/{k}": v.float().mean() for k, v in output["metrics"].items()})
        scalars["total_loss"] = total.detach()
        return total, (output, scalars)


def build_model(config: Mapping[str, Any], model_name: Optional[str] = None,
                device: Optional[str] = None) -> ModelShell:
    """``model_attributes.<name>`` → registered class → ``ModelShell`` on
    ``device`` (default CUDA; see ``resolve_device``)."""
    import antmmf_torch.models  # noqa: F401  (registers the models)

    config = convert_to_config(config)
    attributes = config.get("model_attributes", config)
    if model_name is None:
        names = list(attributes.keys())
        if len(names) != 1:
            raise ValueError(
                f"model_name required when model_attributes has {len(names)} entries")
        model_name = names[0]
    model_config = attributes.get(model_name, {}).to_dict()
    if model_config.get("losses"):
        raise NotImplementedError("config-declared losses are not ported yet; the model's "
                                  "own losses are")
    # training_parameters.dtype_policy.compute is the default compute dtype
    # when the model config pins none
    policy_dtype = config.get_dotted("training_parameters.dtype_policy.compute")
    if policy_dtype and "dtype_str" not in model_config:
        model_config["dtype_str"] = str(policy_dtype)
    cls = registry.get_model_class(model_config.get("model_class", model_name))
    dev = resolve_device(device)
    return ModelShell(cls.from_config(model_config, device=dev), dev,
                      Metrics(model_config.get("metrics", [])))
