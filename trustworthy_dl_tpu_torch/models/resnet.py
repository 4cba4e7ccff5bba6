"""ResNet family (32 / 50 / 101), NHWC, as plain functions.

Counterpart of ``trustworthy_dl_tpu/models/resnet.py``:

* ResNet-32: the CIFAR variant, 3 stages of 5 basic blocks at 16/32/64
  channels, a 3x3 stem;
* ResNet-50/101: bottleneck blocks in stages [3, 4, 6, 3] / [3, 4, 23, 3]
  at base widths 64-512, a 7x7 stride-2 stem and a 3x3 max pool, both
  skipped for small inputs (``small_input``, sides up to 64: the stem is
  3x3 at stride 1).

GroupNorm replaces BatchNorm.  The first block of every stage after the
first strides by 2, and a block whose stride or width changes has a 1x1
projection (``proj`` + ``gn_proj``) on its residual.  The parameter tree
is JAX's (``blocks`` a list of dicts), so converted weights are used as
they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from trustworthy_dl_tpu_torch.models import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet32"
    num_classes: int = 10
    stage_sizes: Tuple[int, ...] = (5, 5, 5)
    widths: Tuple[int, ...] = (16, 32, 64)
    bottleneck: bool = False
    stem_width: int = 16
    small_input: bool = True   # CIFAR-style stem (3x3, no max pool)
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def from_name(name: str, num_classes: int = 10, small_input: bool = True,
                  **overrides: Any) -> "ResNetConfig":
        key = name.lower()
        presets = {
            "resnet32": dict(stage_sizes=(5, 5, 5), widths=(16, 32, 64),
                             bottleneck=False, stem_width=16),
            "resnet50": dict(stage_sizes=(3, 4, 6, 3),
                             widths=(64, 128, 256, 512), bottleneck=True,
                             stem_width=64),
            "resnet101": dict(stage_sizes=(3, 4, 23, 3),
                              widths=(64, 128, 256, 512), bottleneck=True,
                              stem_width=64),
        }
        if key not in presets:
            raise ValueError(f"unknown resnet {name!r}")
        kwargs = dict(presets[key])
        kwargs.update(overrides)
        return ResNetConfig(name=key, num_classes=num_classes,
                            small_input=small_input, **kwargs)


def _block_out_width(cfg: ResNetConfig, width: int) -> int:
    return width * 4 if cfg.bottleneck else width


def init_block(generator: torch.Generator, cin: int, width: int,
               stride: int, cfg: ResNetConfig, device: Any = "cpu"
               ) -> Params:
    cout = _block_out_width(cfg, width)
    if cfg.bottleneck:
        p: Params = {
            "conv1": L.conv_init(generator, 1, 1, cin, width, device),
            "gn1": L.groupnorm_init(width, device),
            "conv2": L.conv_init(generator, 3, 3, width, width, device),
            "gn2": L.groupnorm_init(width, device),
            "conv3": L.conv_init(generator, 1, 1, width, cout, device),
            "gn3": L.groupnorm_init(cout, device),
        }
    else:
        p = {
            "conv1": L.conv_init(generator, 3, 3, cin, width, device),
            "gn1": L.groupnorm_init(width, device),
            "conv2": L.conv_init(generator, 3, 3, width, cout, device),
            "gn2": L.groupnorm_init(cout, device),
        }
    if stride != 1 or cin != cout:
        p["proj"] = L.conv_init(generator, 1, 1, cin, cout, device)
        p["gn_proj"] = L.groupnorm_init(cout, device)
    return p


def block_forward(p: Params, x: torch.Tensor, stride: int,
                  cfg: ResNetConfig) -> torch.Tensor:
    dtype = cfg.dtype
    residual = x
    if cfg.bottleneck:
        y = F.relu(L.groupnorm(p["gn1"], L.conv2d(p["conv1"], x, 1,
                                                  "SAME", dtype)))
        y = F.relu(L.groupnorm(p["gn2"], L.conv2d(p["conv2"], y, stride,
                                                  "SAME", dtype)))
        y = L.groupnorm(p["gn3"], L.conv2d(p["conv3"], y, 1, "SAME", dtype))
    else:
        y = F.relu(L.groupnorm(p["gn1"], L.conv2d(p["conv1"], x, stride,
                                                  "SAME", dtype)))
        y = L.groupnorm(p["gn2"], L.conv2d(p["conv2"], y, 1, "SAME", dtype))
    if "proj" in p:
        residual = L.groupnorm(p["gn_proj"], L.conv2d(p["proj"], x, stride,
                                                      "SAME", dtype))
    return F.relu(y + residual.to(y.dtype))


def _block_plan(cfg: ResNetConfig) -> List[Tuple[int, int]]:
    """[(width, stride), ...] flattened over stages."""
    plan = []
    for stage, (size, width) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
        for i in range(size):
            plan.append((width, 2 if (i == 0 and stage > 0) else 1))
    return plan


def init_params(cfg: ResNetConfig, generator: torch.Generator,
                device: Any = "cpu") -> Params:
    """f32 weights drawn from ``generator`` with JAX's scheme (He-normal
    convs, unit GroupNorms, a normal(0.01) head); the draws differ from
    JAX's (another generator)."""
    stem_kernel = 3 if cfg.small_input else 7
    params: Params = {
        "stem": L.conv_init(generator, stem_kernel, stem_kernel, 3,
                            cfg.stem_width, device),
        "gn_stem": L.groupnorm_init(cfg.stem_width, device),
        "blocks": [],
    }
    cin = cfg.stem_width
    for width, stride in _block_plan(cfg):
        params["blocks"].append(init_block(generator, cin, width, stride,
                                           cfg, device))
        cin = _block_out_width(cfg, width)
    params["head"] = L.dense_init(generator, cin, cfg.num_classes,
                                  scale=0.01, device=device)
    return params


def forward(params: Params, x: torch.Tensor, cfg: ResNetConfig
            ) -> torch.Tensor:
    """x: [B, H, W, 3] -> f32 logits [B, num_classes]."""
    dtype = cfg.dtype
    stem_stride = 1 if cfg.small_input else 2
    y = L.conv2d(params["stem"], x.to(dtype), stem_stride, "SAME", dtype)
    y = F.relu(L.groupnorm(params["gn_stem"], y))
    if not cfg.small_input:
        y = L.max_pool(y, 3, 2)
    for p, (_, stride) in zip(params["blocks"], _block_plan(cfg)):
        y = block_forward(p, y, stride, cfg)
    pooled = L.avg_pool_global(y).float()
    return L.dense(params["head"], pooled)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ResNetConfig) -> torch.Tensor:
    logits = forward(params, batch["input"], cfg)
    return L.cross_entropy_loss(logits, batch["target"])


__all__ = ["ResNetConfig", "block_forward", "forward", "init_block",
           "init_params", "loss_fn"]
