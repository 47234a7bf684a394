"""ResNet-18 on log-mel spectrograms: port of ``adfmsl/models/resnet.py``
(``BasicBlock`` :19, ``ResNet18`` :43).

The basic-block layout 2-2-2-2 (64, 128, 256, 512 channels) over the log-mel
front end (80 mels), channels-last (B, H, W, C) as flax, convolutions in the
trunk dtype. flax's 'SAME' padding is asymmetric at stride 2 on even sizes
(the 7x7/2 stem on 404 frames pads 2 | 3; the 3x3/2 max pool, with -inf, and
the 3x3/2 block convs pad 0 | 1), so it is applied explicitly
(``models/blocks.py:same_pads``). Every BatchNorm (stem, blocks, projection
shortcut) uses the batch statistics in train mode (``ops/norm.py:bn_forward``).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from adfmsl_torch.config.base import ModelConfig
from adfmsl_torch.models.blocks import conv2d_nhwc, max_pool2d_nhwc
from adfmsl_torch.models.lcnn import SpectralModel, mean_pooled
from adfmsl_torch.ops.norm import batch_norm, bn_forward

STAGES = ((64, 2), (128, 2), (256, 2), (512, 2))       # channels, blocks


class BasicBlock(nn.Module):
    """conv3x3(stride) -> BN -> ReLU -> conv3x3 -> BN, plus the input (through a
    strided 1x1 conv and BN when the stride or width changes), then ReLU.
    Bias-free convolutions."""

    def __init__(self, in_channels: int, channels: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.conv1 = nn.Conv2d(in_channels, channels, 3, bias=False)
        self.bn1 = batch_norm(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, bias=False)
        self.bn2 = batch_norm(channels)
        if stride != 1 or in_channels != channels:
            self.proj = nn.Conv2d(in_channels, channels, 1, bias=False)
            self.proj_bn = batch_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, train = self.dtype, self.training
        h = conv2d_nhwc(x, self.conv1, dt, self.stride)
        h = torch.relu(bn_forward(h, self.bn1, dt, train))
        h = bn_forward(conv2d_nhwc(h, self.conv2, dt), self.bn2, dt, train)
        if hasattr(self, "proj"):
            x = bn_forward(conv2d_nhwc(x, self.proj, dt, self.stride), self.proj_bn, dt,
                           train)
        return torch.relu(h + x)


class ResNet18(SpectralModel):
    """stem 7x7/2 -> BN -> ReLU -> max pool 3x3/2 (SAME) -> four stages of two
    basic blocks (stride 2 at the head of stages 1-3) -> global mean -> fc.
    Block names follow flax's: ``layer{i}_{j}``."""

    def __init__(self, cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        self.stem = nn.Conv2d(1, 64, 7, bias=False)
        self.stem_bn = batch_norm(64)
        cin = 64
        for i, (ch, n_blocks) in enumerate(STAGES):
            for j in range(n_blocks):
                stride = 2 if (j == 0 and i > 0) else 1
                self.add_module(f"layer{i}_{j}", BasicBlock(cin, ch, stride, self.dtype))
                cin = ch
        self.fc = nn.Linear(cin, cfg.architecture.nb_classes)
        self._finish(device, generator)

    def trunk(self, feats: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = conv2d_nhwc(feats[..., None], self.stem, dt, stride=2)
        h = torch.relu(bn_forward(h, self.stem_bn, dt, self.training))
        h = max_pool2d_nhwc(h, 3, 2, same=True)
        for i, (_, n_blocks) in enumerate(STAGES):
            for j in range(n_blocks):
                h = getattr(self, f"layer{i}_{j}")(h)
        return mean_pooled(h, (1, 2))

    def head(self, pooled: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        return self.outputs(self.fc(pooled), pooled)
