"""RawNet2 encoder, the 'main' model's backbone (port of ``adfmsl/models/rawnet.py``).

SincConv -> |.| -> MaxPool3 -> BN -> SELU -> six residual blocks, each gated by
an FC attention (y = sigmoid(fc(mean_t(h))); h = h*y + y) -> BN -> SELU -> GRU
-> last hidden state -> fc1_gru. Channels 128 -> 128 -> 128 -> 256 -> 256 ->
256 -> 256. Layout (B, T, C) throughout, as adfmsl.

In train mode every BatchNorm normalises with the batch statistics and moves
its running statistics (``ops/norm.py:bn_train``). With
``fused_eval_frontend`` the front end runs kernel K3 at eval, and with
``fused_train_frontend`` in train mode (through ``ops/sinc_fused.py:
sinc_abs_pool``, whose backward recomputes the composition), for batches of at
most 16 (``models/sincnet.py``); with ``fused_eval_trunk`` and a bf16 trunk
every block runs its folded body as kernel K1 (``act='leaky', pool=3``) at
eval.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adfmsl_torch.models.blocks import GRU, conv_nhc
from adfmsl_torch.models.sincnet import SincConv
from adfmsl_torch.ops.norm import batch_norm, bn_forward
from adfmsl_torch.ops.resblock_fused import fold_block_params, resblock_eval
from adfmsl_torch.utils.profiling import annotate


def max_pool3(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool(x, (3,), strides=(3,))`` of a (B, T, C) tensor: VALID,
    the ``T % 3`` tail dropped. Its gradient goes to the first maximum of each
    window, as XLA's select-and-scatter routes it; ``ops/sinc.py:max_pool3_nhc``
    (``jnp.max``'s form, used by the front end) splits it between tied maxima,
    which a bf16 trunk meets often."""
    return F.max_pool1d(x.transpose(1, 2), 3).transpose(1, 2)


class RawNetBlock(nn.Module):
    """BN -> LeakyReLU(0.3) -> Conv k3 -> BN -> LeakyReLU -> Conv k3, plus the
    input (a 1x1 conv on a channel change), then VALID MaxPool3 (adfmsl
    ``_RawNetBlock`` :23-83). ``first`` drops the leading BN/LeakyReLU. The
    BNs run at the trunk dtype, in train mode on the batch statistics.

    With ``fused_eval`` and a bf16 trunk the body runs folded at eval, as
    adfmsl's (:40-62): BN stats become per-channel affines (``fold_block_params``,
    recomputed every forward) and ``resblock_eval(act='leaky', pool=3)`` runs
    the whole block as kernel K1."""

    def __init__(self, in_channels: int, out_channels: int, first: bool = False,
                 fused_eval: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.first = first
        self.fused_eval = fused_eval
        self.dtype = dtype
        if not first:
            self.bn1 = batch_norm(in_channels)
        self.conv1 = nn.Conv1d(in_channels, out_channels, 3, padding=1)
        self.bn2 = batch_norm(out_channels)
        self.conv2 = nn.Conv1d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.downsample = nn.Conv1d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        train = self.training
        if self.fused_eval and self.dtype == torch.bfloat16 and not train:
            tensors = dict(self.named_parameters())
            tensors.update(self.named_buffers())
            with annotate("stage.k1.weights"):
                ops = fold_block_params(tensors, first=self.first)
            y, _ = resblock_eval(x.to(torch.bfloat16).contiguous(), *ops,
                                 act="leaky", pool=3)
            return y
        dt = self.dtype
        h = x
        if not self.first:
            h = F.leaky_relu(bn_forward(h, self.bn1, dt, train), 0.3)
        h = conv_nhc(h, self.conv1, dt)
        h = F.leaky_relu(bn_forward(h, self.bn2, dt, train), 0.3)
        h = conv_nhc(h, self.conv2, dt)
        skip = x.to(dt)
        if self.in_channels != self.out_channels:
            skip = conv_nhc(x, self.downsample, dt)
        return max_pool3(h + skip)


class RawNetEncoder(nn.Module):
    """(B, T) raw audio -> (B, feature_dim) f32 utterance embedding (adfmsl
    ``RawNetEncoder`` :86-143)."""

    def __init__(self, sinc_channels: int = 128, sinc_kernel: int = 251,
                 block_channels: Sequence[int] = (128, 128, 256, 256, 256, 256),
                 gru_hidden: int = 1024, gru_layers: int = 1, feature_dim: int = 1024,
                 sample_rate: int = 16000, sinc_formula: str = "textbook",
                 fused_eval_frontend: bool = False, fused_train_frontend: bool = False,
                 fused_eval_trunk: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_blocks = len(block_channels)
        self.sinc = SincConv(sinc_channels, sinc_kernel, sample_rate,
                             formula=sinc_formula,
                             exact_fp32=dtype == torch.float32, post="abs_pool3",
                             fused_eval=fused_eval_frontend,
                             fused_train=fused_train_frontend)
        self.first_bn = batch_norm(sinc_channels)
        cin = sinc_channels
        for i, cout in enumerate(block_channels):
            self.add_module(f"block{i}", RawNetBlock(cin, cout, first=(i == 0),
                                                     fused_eval=fused_eval_trunk,
                                                     dtype=dtype))
            self.add_module(f"fc_attention{i}", nn.Linear(cout, cout))
            cin = cout
        self.bn_before_gru = batch_norm(cin)
        self.gru = GRU(cin, gru_hidden, layers=gru_layers)
        self.fc1_gru = nn.Linear(gru_hidden, feature_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        train = self.training
        h = self.sinc(x)                                          # (B, T3, C) f32
        # front-end glue at trunk width: BN in f32, cast to the trunk dtype
        h = F.selu(bn_forward(h.to(self.dtype), self.first_bn, self.dtype, train))
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}")(h)
            # FC attention gate: the time mean in f32 over the block's output
            # (adfmsl :130), the gate back at trunk width before h*y + y
            y = torch.sigmoid(getattr(self, f"fc_attention{i}")(h.float().mean(dim=1)))
            y = y.to(h.dtype)[:, None, :]
            h = h * y + y
        # bn_before_gru has no dtype: flax promotes its bf16 input to f32, so
        # the GRU runs in f32
        h = F.selu(bn_forward(h, self.bn_before_gru, torch.float32, train))
        return self.fc1_gru(self.gru(h))
