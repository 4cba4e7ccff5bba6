"""Model factory: ``create_model(name)`` -> a :class:`ModelBundle`.

Counterpart of ``trustworthy_dl_tpu/models/factory.py``: a model as plain
functions over an explicit parameter dict, for the GPT-2 family and its
Mixture-of-Experts variants (``kind="lm"``) and ResNet-32/50/101 and
VGG-11/13/16 (``kind="vision"``, NHWC images of
``input_spec["image_shape"]``, ``num_classes`` labels).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from trustworthy_dl_tpu_torch.models import gpt2, moe, resnet, vgg
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

Params = Dict[str, Any]


@dataclasses.dataclass
class ModelBundle:
    """A model as data: functions + metadata."""

    name: str
    kind: str                       # "lm" | "vision"
    config: Any
    init: Callable[[torch.Generator, Any], Params]   # (generator, device)
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    loss: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    num_blocks: int
    input_spec: Dict[str, Any]
    # (params, tokens) -> (logits, features, mean_logits)
    apply_monitor: Optional[Callable] = None
    # (params, batch) -> (loss, features, mean_logits[, model_aux]): the
    # step's hot path; the MoE family adds its diagnostics dict.  None
    # (the vision models): the step takes ``apply`` and the
    # cross-entropy, with the logits as the monitored features.
    loss_monitor: Optional[Callable] = None
    # Whether an LM's validation may take the fused head (logits never
    # materialized); False for a family whose loss carries diagnostics.
    fused_eval_head: bool = True

    def example_batch(self, batch_size: int,
                      generator: Optional[torch.Generator] = None,
                      device: Any = "cpu") -> Dict[str, torch.Tensor]:
        """A random {'input', 'target'} batch matching the input contract:
        token windows, or standard-normal images and class labels."""
        if self.kind == "lm":
            seq_len = self.input_spec["seq_len"]
            vocab = self.input_spec["vocab_size"]
            tokens = torch.randint(0, vocab, (batch_size, seq_len + 1),
                                   generator=generator).to(device)
            return {"input": tokens[:, :-1], "target": tokens[:, 1:]}
        h, w, c = self.input_spec["image_shape"]
        images = torch.randn(batch_size, h, w, c, generator=generator)
        labels = torch.randint(0, self.input_spec["num_classes"],
                               (batch_size,), generator=generator)
        return {"input": images.to(device), "target": labels.to(device)}

    def num_params(self, params: Params) -> int:
        return sum(int(p.numel()) for p in tree_leaves(params))


class ModelFactory:
    """Creates models by name: gpt2[-medium|-large|-xl], their MoE
    variants gpt2[-size]-moe, resnet32/50/101, vgg11/13/16.  ``overrides`` reach the family config (``seq_len`` sets
    an LM's input contract; ``image_shape`` and ``num_classes`` a vision
    model's, a side up to 64 taking the small-input ResNet stem)."""

    def create_model(self, model_name: str, **overrides: Any) -> ModelBundle:
        name = model_name.lower()
        if name.startswith("gpt"):
            # gpt2[-size]-moe swaps the dense MLP for the expert layer;
            # its diagnostics rule out the fused eval head.
            is_moe = name.endswith("-moe")
            mod, config_cls = ((moe, moe.MoEConfig) if is_moe
                               else (gpt2, gpt2.GPT2Config))
            seq_len = overrides.pop("seq_len", 128)
            cfg = config_cls.from_name(name, **overrides)
            return ModelBundle(
                name=name, kind="lm", config=cfg,
                init=lambda gen, device="cpu", c=cfg: mod.init_params(
                    c, gen, device),
                apply=lambda p, x, c=cfg: mod.forward(p, x, c),
                loss=lambda p, b, c=cfg: mod.loss_fn(p, b, c),
                num_blocks=cfg.n_layer,
                input_spec={"seq_len": seq_len, "vocab_size": cfg.vocab_size},
                apply_monitor=lambda p, x, c=cfg: mod.forward_with_monitor(
                    p, x, c),
                loss_monitor=lambda p, b, c=cfg: mod.loss_with_monitor(
                    p, b, c),
                fused_eval_head=not is_moe,
            )
        if name.startswith("resnet"):
            num_classes = overrides.pop("num_classes", 10)
            image = tuple(overrides.pop("image_shape", (32, 32, 3)))
            cfg = resnet.ResNetConfig.from_name(
                name, num_classes=num_classes, small_input=image[0] <= 64,
                **overrides)
            return ModelBundle(
                name=name, kind="vision", config=cfg,
                init=lambda gen, device="cpu", c=cfg: resnet.init_params(
                    c, gen, device),
                apply=lambda p, x, c=cfg: resnet.forward(p, x, c),
                loss=lambda p, b, c=cfg: resnet.loss_fn(p, b, c),
                num_blocks=sum(cfg.stage_sizes),
                input_spec={"image_shape": image, "num_classes": num_classes},
            )
        if name.startswith("vgg"):
            num_classes = overrides.pop("num_classes", 10)
            image = tuple(overrides.pop("image_shape", (32, 32, 3)))
            cfg = vgg.VGGConfig.from_name(name, num_classes=num_classes,
                                          **overrides)
            return ModelBundle(
                name=name, kind="vision", config=cfg,
                init=lambda gen, device="cpu", c=cfg: vgg.init_params(
                    c, gen, device),
                apply=lambda p, x, c=cfg: vgg.forward(p, x, c),
                loss=lambda p, b, c=cfg: vgg.loss_fn(p, b, c),
                num_blocks=len([e for e in cfg.plan if e != "M"]),
                input_spec={"image_shape": image, "num_classes": num_classes},
            )
        raise ValueError(f"unknown model {model_name!r}")


def create_model(model_name: str, **overrides: Any) -> ModelBundle:
    return ModelFactory().create_model(model_name, **overrides)


#: The JAX package's alias.
get_model = create_model


__all__ = ["ModelBundle", "ModelFactory", "create_model", "get_model"]
