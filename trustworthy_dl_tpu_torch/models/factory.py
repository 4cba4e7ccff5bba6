"""Model factory: ``create_model(name)`` -> a :class:`ModelBundle`.

Counterpart of ``trustworthy_dl_tpu/models/factory.py`` for the GPT-2
family: a model as plain functions over an explicit parameter dict.  The
ResNet, VGG and MoE families are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

Params = Dict[str, Any]


@dataclasses.dataclass
class ModelBundle:
    """A model as data: functions + metadata."""

    name: str
    kind: str                       # "lm"
    config: Any
    init: Callable[[torch.Generator, Any], Params]   # (generator, device)
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    loss: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    num_blocks: int
    input_spec: Dict[str, Any]
    # (params, tokens) -> (logits, features, mean_logits)
    apply_monitor: Optional[Callable] = None
    # (params, batch) -> (loss, features, mean_logits): the step's hot path.
    loss_monitor: Optional[Callable] = None

    def example_batch(self, batch_size: int,
                      generator: Optional[torch.Generator] = None,
                      device: Any = "cpu") -> Dict[str, torch.Tensor]:
        """A random {'input', 'target'} batch matching the input contract."""
        seq_len = self.input_spec["seq_len"]
        vocab = self.input_spec["vocab_size"]
        tokens = torch.randint(0, vocab, (batch_size, seq_len + 1),
                               generator=generator)
        tokens = tokens.to(device)
        return {"input": tokens[:, :-1], "target": tokens[:, 1:]}

    def num_params(self, params: Params) -> int:
        return sum(int(p.numel()) for p in tree_leaves(params))


def create_model(model_name: str, **overrides: Any) -> ModelBundle:
    """GPT-2 sizes by name; ``overrides`` reach the config (``seq_len``
    sets the input contract)."""
    name = model_name.lower()
    if not name.startswith("gpt") or name.endswith("-moe"):
        raise ValueError(f"unknown or not yet ported model {model_name!r} "
                         "(the port has the dense GPT-2 family)")
    seq_len = overrides.pop("seq_len", 128)
    cfg = gpt2.GPT2Config.from_name(name, **overrides)
    return ModelBundle(
        name=name, kind="lm", config=cfg,
        init=lambda gen, device="cpu", c=cfg: gpt2.init_params(c, gen,
                                                               device),
        apply=lambda p, x, c=cfg: gpt2.forward(p, x, c),
        loss=lambda p, b, c=cfg: gpt2.loss_fn(p, b, c),
        num_blocks=cfg.n_layer,
        input_spec={"seq_len": seq_len, "vocab_size": cfg.vocab_size},
        apply_monitor=lambda p, x, c=cfg: gpt2.forward_with_monitor(p, x, c),
        loss_monitor=lambda p, b, c=cfg: gpt2.loss_with_monitor(p, b, c),
    )


__all__ = ["ModelBundle", "create_model"]
