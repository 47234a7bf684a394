"""SE-residual trunk blocks (port of ``adfmsl/models/blocks.py``).

Ported: ``SEBlock`` (:26), ``ResBlockSE`` (:115) in every one of its block
semantics ('tpu' :223-269, the reference checkpoints' 'reference', 'maze2'
and 'maze3' :270-308, 'fmsl_plain' / 'fmsl_se' :151-184 and 'fmsl_adaptive'
:186-221), in train and eval mode, with the 'tpu' block's folded eval body
(:310-350), ``ResStack`` (:353), the Wav2Vec2 models' sequence blocks
``AttentiveStatsPooling`` (:373),
``TransformerEncoderLayer`` (:395), ``TransformerEncoderStack`` (:420),
``PlainTransformerEncoder`` (:451) and maze8's ``ConvFMSLLayer`` (:473), and
the (optionally stacked) ``GRU`` (:548) that returns its last hidden state.
Public functions keep adfmsl's (B, T, C) channels-last layout; a (B, C, T)
view exists only around ``conv1d`` / ``avg_pool1d`` calls.

Numerics follow flax's rounding points: a layer with a ``dtype`` casts its
input, kernel and bias to it and adds the bias after the product; a layer
without one (the ASP and ConvFMSL Denses and convs, the LayerNorms, the
BatchNorms of ConvFMSL and of every non-'tpu' residual block) computes in the
promoted dtype, f32 for a bf16 input, and returns f32. BatchNorm semantics: see
``adfmsl_torch/ops/norm.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adfmsl_torch.models.w2v2 import SelfAttention, dense, layer_norm
from adfmsl_torch.ops.dropout import dropout
from adfmsl_torch.ops.norm import batch_norm, bn_forward
from adfmsl_torch.ops.resblock_fused import fold_block_params, overlap_avg_pool, resblock_eval
from adfmsl_torch.utils.profiling import annotate

_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def init_like_flax_(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Re-initialise convs and linears with adfmsl's initialisers (lecun_normal
    kernels, zero biases) and BatchNorms with ones/zeros and fresh stats."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()              # Cin*K(*K) or in_features
            with torch.no_grad():
                lecun_normal_(m.weight, fan_in, generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()


def conv_nhc(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype,
             stride: int = 1) -> torch.Tensor:
    """Conv of a (B, T, C) tensor in ``dtype`` (flax ``nn.Conv(dtype=...)``
    casts input, kernel and bias to it), padded by K // 2 on both sides: flax's
    'SAME' at stride 1, its explicit ``((1, 1),)`` for K 3 and its 'SAME' for
    K 1 at any stride."""
    w = conv.weight.to(dtype)
    b = conv.bias.to(dtype) if conv.bias is not None else None
    y = F.conv1d(x.transpose(1, 2).to(dtype), w, b, stride=stride,
                 padding=conv.kernel_size[0] // 2)
    return y.transpose(1, 2)


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax / XLA 'SAME' padding (lo, hi) of one axis: ceil(size/stride) outputs,
    the total split with the odd sample on the high side (asymmetric at
    stride 2 on even sizes, where torch's ``padding=`` would be symmetric)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
                stride: int = 1) -> torch.Tensor:
    """SAME conv of a (B, H, W, C) tensor in ``dtype`` (flax ``nn.Conv``), as a
    channels-last view of an NCHW conv."""
    kh, kw = conv.kernel_size
    (ht, hb), (wl, wr) = same_pads(x.shape[1], kh, stride), same_pads(x.shape[2], kw, stride)
    h = x.permute(0, 3, 1, 2).to(dtype)
    pad = (ht, wl)
    if (ht, wl) != (hb, wr):
        h, pad = F.pad(h, (wl, wr, ht, hb)), 0
    b = conv.bias.to(dtype) if conv.bias is not None else None
    return F.conv2d(h, conv.weight.to(dtype), b, stride=stride, padding=pad).permute(0, 2, 3, 1)


def max_pool2d_nhwc(x: torch.Tensor, k: int, stride: int, same: bool = False) -> torch.Tensor:
    """flax ``nn.max_pool`` of a (B, H, W, C) tensor: VALID, or SAME with -inf
    padding."""
    h = x.permute(0, 3, 1, 2)
    if same:
        (ht, hb), (wl, wr) = same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k, stride)
        h = F.pad(h, (wl, wr, ht, hb), value=float("-inf"))
    return F.max_pool2d(h, k, stride).permute(0, 2, 3, 1)


def adaptive_avg_resample(x: torch.Tensor, lout: int) -> torch.Tensor:
    """adfmsl's ``_adaptive_avg_resample`` (:92-112): torch's
    ``adaptive_avg_pool1d`` over time, (B, T, C) -> (B, lout, C) with lout >= T,
    so that a bin averages one or two elements. adfmsl blends them with f32
    weights, which promotes a bf16 input, so the result is f32 unless T equals
    lout (then ``x`` itself)."""
    if x.shape[1] == lout:
        return x
    if x.shape[1] > lout:
        raise ValueError(f"adaptive resample expects upsampling, got {x.shape[1]}->{lout}")
    return F.adaptive_avg_pool1d(x.float().transpose(1, 2), lout).transpose(1, 2)


class SEBlock(nn.Module):
    """Squeeze-excitation over the time axis; reduction 16, bias-free
    (maze4.py:149-163)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = nn.Linear(channels, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, channels, bias=False)

    def gate(self, pooled: torch.Tensor) -> torch.Tensor:
        """(B, C) f32 time-mean -> (B, C) f32 gate."""
        return torch.sigmoid(self.fc2(torch.relu(self.fc1(pooled))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # mean in f32; the gate goes back to trunk width before the multiply
        g = self.gate(x.float().mean(dim=1))
        return x * g[:, None, :].to(x.dtype)


# the bias-free, conv-strided blocks of the FMSL files (adfmsl :151-184)
_FMSL_PLAIN = ("fmsl_plain", "fmsl_se")
# the semantics with an SE gate; adfmsl's last branch (:270-308) also takes a
# name it does not know, as the 'reference' block with no SE
_WITH_SE = ("tpu", "reference", "maze2", "maze3", "fmsl_adaptive") + _FMSL_PLAIN


class ResBlockSE(nn.Module):
    """Pre-activation residual block (adfmsl ``ResBlockSE`` :115) in one of
    adfmsl's block semantics; ``first`` drops the leading BN/ReLU (stack
    head). In train mode the BNs use the batch statistics (``bn_train``) and
    the dropout draws from the generator passed to ``forward``.

    - 'tpu' (:223-269): the overlap avg pool downsamples the raw block input
      first; then BN -> ReLU -> Conv(k3) -> BN -> ReLU -> dropout -> Conv(k3),
      plus a BN-free identity skip (a 1x1 conv on a channel change only), then
      SE. Its BNs emit the trunk dtype.
    - 'reference' (maze4.py:105-147; :270-308): the same body at full
      length, ``out = body + skip`` with a 1x1 conv on the skip on a stride or
      a channel change, then the overlap pool ``AvgPool(2s-1, s, pad s-1)``
      counting its pads, then SE. 'maze2' takes the 1x1 conv on a channel
      change only; 'maze3' too, and its SE gates the body before the add, with
      none after the pool. Any other name is this block with no SE.
    - 'fmsl_plain' / 'fmsl_se' (:151-184): bias-free convs, ``conv1`` strided
      (padding 1), the pre-activation feeds both branches, dropout after
      ``conv2``, a bias-free strided 1x1 skip on a stride or a channel change,
      SE after the add ('fmsl_se': on the body before it).
    - 'fmsl_adaptive' (:186-221): biased convs with no stride, dropout after
      ``conv2``; the skip is the pre-activation, through a 1x1 conv on a
      stride or a channel change, then the overlap pool and back up to the
      body's length (``adaptive_avg_resample``); SE after the add. The block
      never downsamples.

    Outside 'tpu' the BNs take no dtype: they return f32 in a bf16 model, and
    the next conv casts, as in adfmsl.

    With ``fused_eval``, 'tpu' semantics and a bf16 trunk, at eval, the body
    runs folded: BN stats become per-channel affines (``fold_block_params``,
    recomputed every forward so a later ``load_state_dict`` is never stale)
    and ``resblock_eval`` runs the whole body as one kernel (K1) returning the
    output and its f32 channel sums, which feed the SE gate; at stride 2 K1
    also runs the overlap avg pool, on the raw input as it loads it."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dropout_rate: float = 0.3, first: bool = False, use_se: bool = True,
                 semantics: str = "tpu", fused_eval: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.stride = stride
        self.dropout_rate = dropout_rate
        self.first = first
        self.semantics = semantics
        self.fused_eval = fused_eval
        self.dtype = dtype
        plain = semantics in _FMSL_PLAIN
        reshape = in_channels != out_channels
        if semantics in _FMSL_PLAIN + ("fmsl_adaptive",):
            skip_conv = reshape or stride != 1
        else:
            skip_conv = reshape or (semantics == "reference" and stride > 1)
        if not first:
            self.bn1 = batch_norm(in_channels)
        self.conv1 = nn.Conv1d(in_channels, out_channels, 3, padding=1, bias=not plain)
        self.bn2 = batch_norm(out_channels)
        self.conv2 = nn.Conv1d(out_channels, out_channels, 3, padding=1, bias=not plain)
        if skip_conv:
            self.downsample = nn.Conv1d(in_channels, out_channels, 1, bias=not plain)
        self.se = SEBlock(out_channels) if use_se and semantics in _WITH_SE else None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the 'dropout' stream, needed in train mode."""
        if self.semantics == "tpu":
            return self._tpu(x, generator)
        if self.semantics in _FMSL_PLAIN:
            return self._fmsl_plain(x, generator)
        if self.semantics == "fmsl_adaptive":
            return self._fmsl_adaptive(x, generator)
        return self._reference(x, generator)

    def _pre(self, x: torch.Tensor) -> torch.Tensor:
        """The leading BN (no dtype: f32 out) and ReLU, except at a stack head."""
        if self.first:
            return x
        return torch.relu(bn_forward(x, self.bn1, torch.float32, self.training))

    def _skip(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        if not hasattr(self, "downsample"):
            return x
        return conv_nhc(x, self.downsample, self.dtype, stride)

    def _tpu(self, x, generator):
        train = self.training
        if self.fused_eval and self.dtype == torch.bfloat16 and not train:
            return self._fused_eval_body(x)
        if self.stride > 1:
            x = overlap_avg_pool(x, self.stride)
        dt = self.dtype
        h = x
        if not self.first:
            h = torch.relu(bn_forward(h, self.bn1, dt, train))
        h = conv_nhc(h, self.conv1, dt)
        h = torch.relu(bn_forward(h, self.bn2, dt, train))
        h = dropout(h, self.dropout_rate, generator, train)
        h = conv_nhc(h, self.conv2, dt)
        # the raw input: an f32 x promotes the sum, as in flax
        out = h + self._skip(x)
        return self.se(out) if self.se is not None else out

    def _reference(self, x, generator):
        """'reference', 'maze2', 'maze3' and adfmsl's fall-through (:270-308)."""
        train, dt = self.training, self.dtype
        h = conv_nhc(self._pre(x), self.conv1, dt)
        h = torch.relu(bn_forward(h, self.bn2, torch.float32, train))
        h = dropout(h, self.dropout_rate, generator, train)
        h = conv_nhc(h, self.conv2, dt)
        maze3 = self.semantics == "maze3"
        if self.se is not None and maze3:
            h = self.se(h)
        out = h + self._skip(x)
        if self.stride > 1:
            out = overlap_avg_pool(out, self.stride)
        if self.se is not None and not maze3:
            out = self.se(out)
        return out

    def _fmsl_plain(self, x, generator):
        """'fmsl_plain' and 'fmsl_se' (:151-184)."""
        train, dt = self.training, self.dtype
        pre = self._pre(x)
        h = conv_nhc(pre, self.conv1, dt, self.stride)
        h = torch.relu(bn_forward(h, self.bn2, torch.float32, train))
        h = conv_nhc(h, self.conv2, dt)
        h = dropout(h, self.dropout_rate, generator, train)
        fmsl_se = self.semantics == "fmsl_se"
        if self.se is not None and fmsl_se:
            h = self.se(h)
        out = h + self._skip(pre, self.stride)
        if self.se is not None and not fmsl_se:
            out = self.se(out)
        return out

    def _fmsl_adaptive(self, x, generator):
        """'fmsl_adaptive' (:186-221): the stride resamples the skip alone."""
        train, dt = self.training, self.dtype
        pre = self._pre(x)
        out = conv_nhc(pre, self.conv1, dt)
        out = torch.relu(bn_forward(out, self.bn2, torch.float32, train))
        out = conv_nhc(out, self.conv2, dt)
        out = dropout(out, self.dropout_rate, generator, train)
        skip = self._skip(pre)
        if self.stride > 1:
            skip = adaptive_avg_resample(overlap_avg_pool(skip, self.stride), out.shape[1])
        res = out + skip
        return self.se(res) if self.se is not None else res

    def _fused_eval_body(self, x: torch.Tensor) -> torch.Tensor:
        """The block on its raw input: K1 pools a bf16 ``x`` at stride 2 as it
        loads it; any other input is pooled here first, in its own dtype."""
        stride = self.stride
        if stride == 2 and x.dtype != torch.bfloat16:
            x, stride = overlap_avg_pool(x, stride), 1
        tensors = dict(self.named_parameters())
        tensors.update(self.named_buffers())
        with annotate("stage.k1.weights"):
            pre, w1, b1, w2, bt, skw = fold_block_params(tensors, first=self.first)
        y, sums = resblock_eval(x.to(torch.bfloat16).contiguous(),
                                pre, w1, b1, w2, bt, skw, stride=stride)
        if self.se is not None:
            gate = self.se.gate(sums / y.shape[1])          # the pooled length
            y = y * gate[:, None, :].to(y.dtype)
        return y


class ResStack(nn.Module):
    """A stack of ResBlockSE with per-block (in, out, stride), named block{i},
    all in one block ``semantics``."""

    def __init__(self, specs: Sequence[tuple], dropout_rate: float = 0.3,
                 use_se: bool = True, semantics: str = "tpu", fused_eval: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_blocks = len(specs)
        for i, (cin, cout, stride) in enumerate(specs):
            self.add_module(f"block{i}", ResBlockSE(
                cin, cout, stride, dropout_rate, first=(i == 0), use_se=use_se,
                semantics=semantics, fused_eval=fused_eval, dtype=dtype))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x, generator)
        return x


class AttentiveStatsPooling(nn.Module):
    """Attention-weighted mean || std over time, (B, T, C) -> (B, 2C) f32
    (adfmsl :373-392). The Denses have no dtype: they compute in f32.
    ``use_std=False`` is maze6_fmsl's variant: the raw weighted variance (no
    sqrt, no eps)."""

    def __init__(self, channels: int, hidden: int = 128, use_std: bool = True):
        super().__init__()
        self.use_std = use_std
        self.att1 = nn.Linear(channels, hidden)
        self.att2 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        w = torch.softmax(self.att2(torch.tanh(self.att1(xf))), dim=1)   # (B, T, 1)
        mean = (w * xf).sum(dim=1)
        var = (w * (xf - mean[:, None, :]) ** 2).sum(dim=1)
        second = torch.sqrt(var + 1e-6) if self.use_std else var
        return torch.cat([mean, second], dim=-1)


class TransformerEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` semantics, post-LN with a ReLU FFN
    (adfmsl :395-417): flax's ``MultiHeadDotProductAttention`` and the two
    FFN Denses at ``dtype``, the LayerNorms (flax's eps 1e-6) without one, so
    the output is f32. In train mode the attention weights, the two residual
    branches and the FFN's hidden take dropout from the generator given to
    ``forward``."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int = 2048,
                 dropout_rate: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.self_attn = SelfAttention(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.ff1 = nn.Linear(d_model, d_ff)
        self.ff2 = nn.Linear(d_ff, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate, train, dt = self.dropout_rate, self.training, self.dtype
        attn = self.self_attn(x, dt, rate, generator)
        x = layer_norm(x + dropout(attn, rate, generator, train), self.norm1)
        ff = dropout(torch.relu(dense(x, self.ff1, dt)), rate, generator, train)
        ff = dense(ff, self.ff2, dt)
        return layer_norm(x + dropout(ff, rate, generator, train), self.norm2)


class PlainTransformerEncoder(nn.Module):
    """torch ``nn.TransformerEncoder`` at the trunk width, with no projection
    and no positional embedding (adfmsl :451-470; maze2, maze6): the layers
    ``layer{i}``."""

    def __init__(self, d_model: int, n_heads: int = 8, n_layers: int = 6,
                 d_ff: int = 2048, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                d_model, n_heads, d_ff, dropout_rate, dtype))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, generator)
        return x


class TransformerEncoderStack(PlainTransformerEncoder):
    """``in_proj`` -> a learned positional embedding (``max_len`` rows, normal
    0.02 init) -> the layers -> ``out_proj`` (adfmsl :420-448; maze3_fmsl).
    The projections run at ``dtype``; a sequence longer than ``max_len``
    raises."""

    def __init__(self, in_dim: int, d_model: int = 256, n_heads: int = 8,
                 n_layers: int = 6, d_ff: int = 2048, out_dim: Optional[int] = None,
                 max_len: int = 1000, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(d_model, n_heads, n_layers, d_ff, dropout_rate, dtype)
        self.max_len, self.dtype = max_len, dtype
        self.in_proj = nn.Linear(in_dim, d_model)
        self.pos_embedding = nn.Parameter(torch.zeros(max_len, d_model))
        self.out_proj = nn.Linear(d_model, out_dim or in_dim)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.pos_embedding.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}")
        h = dense(x, self.in_proj, self.dtype) + self.pos_embedding[None, :t]
        return dense(super().forward(h, generator), self.out_proj, self.dtype)


class ConvFMSLLayer(nn.Module):
    """maze8's conv 'FMSL' layer (adfmsl :473-503): a k7 conv to
    ``num_filters`` + BN + ReLU + dropout, a k3 conv + BN + ReLU + dropout, a
    channel attention (mean over time, Dense to num_filters // 4, ReLU, Dense,
    sigmoid), a 1x1 conv back to ``channels``, plus the input. Its convs,
    Denses and BatchNorms have no dtype: they compute in f32, and so does the
    residual sum."""

    def __init__(self, channels: int, num_filters: int = 64, kernel_size: int = 7,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.freq_mod_conv = nn.Conv1d(channels, num_filters, kernel_size,
                                       padding=kernel_size // 2)
        self.freq_mod_bn = batch_norm(num_filters)
        self.spec_enh_conv = nn.Conv1d(num_filters, num_filters, 3, padding=1)
        self.spec_enh_bn = batch_norm(num_filters)
        self.att1 = nn.Linear(num_filters, max(num_filters // 4, 1))
        self.att2 = nn.Linear(max(num_filters // 4, 1), num_filters)
        self.out_proj = nn.Conv1d(num_filters, channels, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        train, f32, rate = self.training, torch.float32, self.dropout_rate
        h = conv_nhc(x.float(), self.freq_mod_conv, f32)
        h = dropout(torch.relu(bn_forward(h, self.freq_mod_bn, f32, train)), rate,
                    generator, train)
        h = conv_nhc(h, self.spec_enh_conv, f32)
        h = dropout(torch.relu(bn_forward(h, self.spec_enh_bn, f32, train)), rate,
                    generator, train)
        att = torch.sigmoid(self.att2(torch.relu(self.att1(h.mean(dim=1)))))
        return x + conv_nhc(h * att[:, None, :], self.out_proj, f32)


class _GRUCell(nn.Module):
    """Parameter twin of flax's ``GRUCell`` as adfmsl lays it out
    (``_GRUCellParams`` :527, ``_GateParams`` :506): input gates ir/iz/in with
    biases, recurrent gates hr/hz without and hn with one."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        for g in ("ir", "iz", "in"):
            self.add_module(g, nn.Linear(in_features, hidden))
        self.hr = nn.Linear(hidden, hidden, bias=False)
        self.hz = nn.Linear(hidden, hidden, bias=False)
        self.hn = nn.Linear(hidden, hidden)


class GRU(nn.Module):
    """A unidirectional GRU of ``layers`` stacked layers over (B, T, C) that
    returns only the last layer's last hidden state (B, H), as RawNet
    consumes it (adfmsl ``GRU`` with ``return_sequences=False``); every layer
    but the last hands its whole sequence to the next. The layers' gates are
    ``cell``, ``cell1``, ``cell2``, ..., as adfmsl's tree names them.

    The gate math is flax's ``GRUCell`` (adfmsl :591-595):
    ``n = tanh(x_n + r * (h_n + b_hn))`` with r/z biases on the input side
    only. ``nn.GRU`` places its biases and orders its gates otherwise
    (``adfmsl/models/port.py:185``), so it is not used. A layer's input
    projection of every step runs as one product before its loop, as adfmsl
    hoists it (:586); the recurrence is a Python loop of one (B, H) x (H, 3H)
    product a step."""

    def __init__(self, in_features: int, hidden: int, layers: int = 1):
        super().__init__()
        if layers < 1:
            raise ValueError(f"a GRU needs at least one layer, got {layers}")
        self.hidden = hidden
        self.layers = layers
        for k in range(layers):
            self.add_module(self._cell_name(k),
                            _GRUCell(in_features if k == 0 else hidden, hidden))

    @staticmethod
    def _cell_name(k: int) -> str:
        return "cell" if k == 0 else f"cell{k}"

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """adfmsl's initialisers: lecun_normal input kernels, orthogonal
        recurrent kernels, zero biases."""
        with torch.no_grad():
            for k in range(self.layers):
                cell = getattr(self, self._cell_name(k))
                for g in ("ir", "iz", "in", "hr", "hz", "hn"):
                    lin = getattr(cell, g)
                    if g.startswith("h"):
                        nn.init.orthogonal_(lin.weight, generator=generator)
                    else:
                        lecun_normal_(lin.weight, lin.in_features, generator)
                    if lin.bias is not None:
                        lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hd = self.hidden
        seq = x
        for k in range(self.layers):
            cell = getattr(self, self._cell_name(k))
            last = k == self.layers - 1
            gi = [getattr(cell, g) for g in ("ir", "iz", "in")]
            gh = [getattr(cell, g) for g in ("hr", "hz", "hn")]
            wi = torch.cat([g.weight for g in gi])                # (3H, C)
            bi = torch.cat([g.bias for g in gi])
            wh = torch.cat([g.weight for g in gh]).T              # (H, 3H)
            bhn = cell.hn.bias
            xi = seq @ wi.T + bi                                  # (B, T, 3H)
            h = xi.new_zeros((x.shape[0], hd))
            states = []
            for t in range(xi.shape[1]):
                xt, hh = xi[:, t], h @ wh
                r = torch.sigmoid(xt[:, :hd] + hh[:, :hd])
                z = torch.sigmoid(xt[:, hd:2 * hd] + hh[:, hd:2 * hd])
                n = torch.tanh(xt[:, 2 * hd:] + r * (hh[:, 2 * hd:] + bhn))
                h = (1.0 - z) * n + z * h
                if not last:
                    states.append(h)
            if not last:
                seq = torch.stack(states, dim=1)                  # (B, T, H)
        return h
