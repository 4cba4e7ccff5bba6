"""VGG family (11 / 13 / 16), NHWC, as plain functions.

Counterpart of ``trustworthy_dl_tpu/models/vgg.py``: the standard
convolution plans (A / B / D) of 3x3 convs, each followed by GroupNorm
and ReLU, with 2x2 max pools; the head is a global average pool and one
linear layer, so the same model takes CIFAR-10 (32x32) and ImageNet-sized
inputs.  A pool is skipped once the map is below 2x2 (CIFAR inputs reach
1x1 before the plan ends).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from trustworthy_dl_tpu_torch.models import layers as L

Params = Dict[str, Any]

# 'M' = max pool; numbers = conv output channels.
VGG_PLANS: Dict[str, Tuple[Union[int, str], ...]] = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"),
}


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    name: str = "vgg16"
    num_classes: int = 10
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def from_name(name: str, num_classes: int = 10, **overrides: Any
                  ) -> "VGGConfig":
        key = name.lower()
        if key not in VGG_PLANS:
            raise ValueError(f"unknown vgg {name!r}")
        return VGGConfig(name=key, num_classes=num_classes, **overrides)

    @property
    def plan(self) -> Tuple[Union[int, str], ...]:
        return VGG_PLANS[self.name]


def init_params(cfg: VGGConfig, generator: torch.Generator,
                device: Any = "cpu") -> Params:
    """f32 weights drawn from ``generator`` with JAX's scheme."""
    params: Params = {"blocks": []}
    cin = 3
    for entry in cfg.plan:
        if entry == "M":
            continue
        cout = int(entry)
        params["blocks"].append(
            {"conv": L.conv_init(generator, 3, 3, cin, cout, device),
             "gn": L.groupnorm_init(cout, device)})
        cin = cout
    params["head"] = L.dense_init(generator, cin, cfg.num_classes,
                                  scale=0.01, device=device)
    return params


def forward(params: Params, x: torch.Tensor, cfg: VGGConfig
            ) -> torch.Tensor:
    """x: [B, H, W, 3] -> f32 logits [B, num_classes]."""
    dtype = cfg.dtype
    y = x.to(dtype)
    bi = 0
    for entry in cfg.plan:
        if entry == "M":
            if y.shape[-3] >= 2 and y.shape[-2] >= 2:
                y = L.max_pool(y, 2, 2)
            continue
        p = params["blocks"][bi]
        y = F.relu(L.groupnorm(p["gn"], L.conv2d(p["conv"], y, 1, "SAME",
                                                 dtype)))
        bi += 1
    pooled = L.avg_pool_global(y).float()
    return L.dense(params["head"], pooled)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: VGGConfig
            ) -> torch.Tensor:
    logits = forward(params, batch["input"], cfg)
    return L.cross_entropy_loss(logits, batch["target"])


__all__ = ["VGGConfig", "VGG_PLANS", "forward", "init_params", "loss_fn"]
