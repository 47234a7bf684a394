"""Independent torch versions of the reference sinc and RawNet models, with the
reference checkpoints' state-dict keys, importing neither JAX nor either
package: ``chip_smoke.py``'s ``reference_ckpt`` phase builds the thesis-style
``.pth`` files it converts from them on a card without JAX, and
``tests/test_torch_ref_checkpoints.py`` holds each against its twin in
``tests/test_port.py`` on the CPU.

Copied from ``tests/test_port.py``: ``TSinc`` :29, ``TSE`` :58, ``TRes`` :69,
``TFMSL`` :98, ``TMaze5`` :114, ``TRawBlock`` :221, ``TRawNet`` :246 and
``TAdaptBlock`` :378; ``TMaze4FMSL`` is maze4_fmsl's layer plan
(maze4_fmsl_standardized.py:216-347, the keys adfmsl's ``models/port.py:
332-353`` maps) from those parts, with ``TMaze7``'s FMSL head (:444-447).
``randomize`` draws every weight and BatchNorm statistic from a
``torch.Generator``.
"""
import math

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as tF

SR = 16000


class TSinc(tnn.Module):
    """Trainable sinc filterbank with the reference's formula / params
    (maze4.py:38-103: low_hz_ / band_hz_ (C, 1), hann periodic=False,
    h = 2f * sinc(2f * pi * n), VALID conv)."""

    def __init__(self, c=128, k=251, sr=SR):
        super().__init__()
        self.k, self.sr = k, sr
        low = 30.0
        high = sr / 2 - 100.0
        mel = np.linspace(2595 * np.log10(1 + low / 700),
                          2595 * np.log10(1 + high / 700), c + 1)
        hz = 700 * (10 ** (mel / 2595) - 1)
        self.low_hz_ = tnn.Parameter(torch.tensor(hz[:-1], dtype=torch.float32).view(-1, 1))
        self.band_hz_ = tnn.Parameter(torch.tensor(np.diff(hz), dtype=torch.float32).view(-1, 1))
        n = (k - 1) / 2.0
        self.register_buffer("n_", torch.arange(-n, n + 1).view(1, -1) / sr)
        self.register_buffer("window_", torch.hann_window(k, periodic=False))

    def forward(self, x):                              # (B, 1, T)
        low = 50.0 + torch.abs(self.low_hz_)
        high = torch.clamp(low + 50.0 + torch.abs(self.band_hz_), 50.0, self.sr / 2)
        f_lo, f_hi = low / self.sr, high / self.sr
        h = (2 * f_hi * torch.sinc(2 * f_hi * math.pi * self.n_)
             - 2 * f_lo * torch.sinc(2 * f_lo * math.pi * self.n_))
        filt = (self.window_ * h).view(-1, 1, self.k)
        return tF.conv1d(x, filt)


class TSE(tnn.Module):
    def __init__(self, c, r=16):
        super().__init__()
        self.fc = tnn.Sequential(tnn.Linear(c, c // r, bias=False), tnn.ReLU(),
                                 tnn.Linear(c // r, c, bias=False), tnn.Sigmoid())

    def forward(self, x):                              # (B, C, T)
        return x * self.fc(x.mean(dim=2)).unsqueeze(-1)


class TRes(tnn.Module):
    """Reference Residual_Block_SE (maze4.py:105-147)."""

    def __init__(self, cin, cout, first=False, stride=1, p=0.3):
        super().__init__()
        self.first = first
        if not first:
            self.bn1 = tnn.BatchNorm1d(cin)
        self.conv1 = tnn.Conv1d(cin, cout, 3, padding=1)
        self.bn2 = tnn.BatchNorm1d(cout)
        self.dropout = tnn.Dropout(p)
        self.conv2 = tnn.Conv1d(cout, cout, 3, padding=1)
        if cin != cout or stride != 1:
            self.conv_downsample = tnn.Conv1d(cin, cout, 1)
        self.pool = tnn.AvgPool1d(2 * stride - 1, stride, stride - 1) if stride > 1 else None

    def forward(self, x):
        h = x if self.first else tF.relu(self.bn1(x))
        h = self.conv2(self.dropout(tF.relu(self.bn2(self.conv1(h)))))
        skip = self.conv_downsample(x) if hasattr(self, "conv_downsample") else x
        out = h + skip
        return self.pool(out) if self.pool is not None else out


class TAdaptBlock(tnn.Module):
    """maze4/7/8_fmsl_standardized.py:112-162: dropout after conv2; the stride
    pools the skip alone, which is resampled back to the body's length."""

    def __init__(self, cin, cout, first=False, stride=1, p=0.3):
        super().__init__()
        self.first = first
        if not first:
            self.bn1 = tnn.BatchNorm1d(cin)
        self.conv1 = tnn.Conv1d(cin, cout, 3, padding=1)
        self.bn2 = tnn.BatchNorm1d(cout)
        self.dropout = tnn.Dropout(p)
        self.conv2 = tnn.Conv1d(cout, cout, 3, padding=1)
        if cin != cout or stride != 1:
            self.conv_downsample = tnn.Conv1d(cin, cout, 1)
        self.pool = tnn.AvgPool1d(2 * stride - 1, stride, stride - 1) if stride > 1 else None

    def forward(self, x):
        if not self.first:
            x = tF.relu(self.bn1(x))
        out = self.dropout(self.conv2(tF.relu(self.bn2(self.conv1(x)))))
        skip = self.conv_downsample(x) if hasattr(self, "conv_downsample") else x
        if self.pool is not None:
            skip = self.pool(skip)
        if skip.size(-1) != out.size(-1):
            skip = tF.adaptive_avg_pool1d(skip, out.size(-1))
        return out + skip


class TFMSL(tnn.Module):
    """Reference AdvancedFMSLSystem's parameters (fmsl_advanced.py:103-150);
    eval forward: project, then l2-normalise."""

    def __init__(self, d, n_proto=3):
        super().__init__()
        self.projection = tnn.Sequential(tnn.Linear(d, d), tnn.BatchNorm1d(d),
                                         tnn.ReLU(), tnn.Dropout(0.1))
        self.prototypes = tnn.Parameter(torch.zeros(n_proto, d))
        self.weight = tnn.Parameter(torch.zeros(2, d))
        self.temperature = tnn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        return tF.normalize(self.projection(x), p=2, dim=-1)

    def am_logits(self, x, s):
        """Eval AM-softmax logits s * cos(embedding, class weight)."""
        return s * (self(x) @ tF.normalize(self.weight, p=2, dim=-1).T)


_SINC_PLAN = [(128, 128), (128, 128), (128, 128), (128, 256)]


class TMaze5(tnn.Module):
    """maze5.py:178-264 (maze4's plan too); with ``fmsl`` maze5_fmsl's Mode A
    refiner between fc1 and fc2. Returns the log-softmax."""

    def __init__(self, fmsl=False):
        super().__init__()
        self.sinc_conv = TSinc()
        self.first_bn = tnn.BatchNorm1d(128)
        self.block0 = TRes(128, 128, first=True)
        self.se0 = TSE(128)
        self.res_blocks = tnn.ModuleList(TRes(a, b, stride=2) for a, b in _SINC_PLAN)
        self.se_blocks = tnn.ModuleList(TSE(b) for _, b in _SINC_PLAN)
        self.fc1 = tnn.Linear(256, 1024)
        self.dropout_fc = tnn.Dropout(0.5)
        self.fc2 = tnn.Linear(1024, 2)
        self.fmsl_system = TFMSL(1024) if fmsl else None

    def forward(self, x):                              # (B, T)
        h = tF.selu(self.first_bn(self.sinc_conv(x.unsqueeze(1))))
        h = self.se0(self.block0(h))
        for blk, se in zip(self.res_blocks, self.se_blocks):
            h = se(blk(h))
        h = self.dropout_fc(self.fc1(h.mean(dim=2)))
        if self.fmsl_system is not None:
            h = self.fmsl_system(h)
        return tF.log_softmax(self.fc2(h), dim=-1)


class TMaze4FMSL(tnn.Module):
    """maze4_fmsl (Mode C): the sinc front end, the adaptive blocks with their
    SE gates, the pooled trunk straight into the FMSL system, AM-softmax
    logits at scale ``s``."""

    def __init__(self, s=2.0):
        super().__init__()
        self.s = s
        self.sinc_conv = TSinc()
        self.first_bn = tnn.BatchNorm1d(128)
        self.block0 = TAdaptBlock(128, 128, first=True)
        self.se0 = TSE(128)
        self.res_blocks = tnn.ModuleList(TAdaptBlock(a, b, stride=2) for a, b in _SINC_PLAN)
        self.se_blocks = tnn.ModuleList(TSE(b) for _, b in _SINC_PLAN)
        self.fmsl_system = TFMSL(256)

    def forward(self, x):
        h = tF.selu(self.first_bn(self.sinc_conv(x.unsqueeze(1))))
        h = self.se0(self.block0(h))
        for blk, se in zip(self.res_blocks, self.se_blocks):
            h = se(blk(h))
        return self.fmsl_system.am_logits(h.mean(dim=2), self.s)


class TRawBlock(tnn.Module):
    """The RawNet residual block (main_fmsl_standardized.py:121-146): leaky
    0.3, k3 convs, 1x1 skip on a channel change, MaxPool1d(3)."""

    def __init__(self, cin, cout, first=False):
        super().__init__()
        self.first = first
        if not first:
            self.bn1 = tnn.BatchNorm1d(cin)
        self.conv1 = tnn.Conv1d(cin, cout, 3, padding=1)
        self.bn2 = tnn.BatchNorm1d(cout)
        self.conv2 = tnn.Conv1d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_downsample = tnn.Conv1d(cin, cout, 1)
        self.mp = tnn.MaxPool1d(3)

    def forward(self, x):
        h = x if self.first else tF.leaky_relu(self.bn1(x), 0.3)
        h = self.conv2(tF.leaky_relu(self.bn2(self.conv1(h)), 0.3))
        skip = self.conv_downsample(x) if hasattr(self, "conv_downsample") else x
        return self.mp(h + skip)


class TRawNet(tnn.Module):
    """RawNet2 with the reference's keys (main_fmsl_standardized.py:101-157):
    Sinc_conv, block0-5, fc_attention0-5, bn_before_gru, a stacked
    batch-first GRU, fc1_gru and fc2_gru (log-softmax out), or with ``fmsl``
    the FMSL system's AM-softmax logits at scale 32."""

    def __init__(self, gru_layers=2, fmsl=False):
        super().__init__()
        self.Sinc_conv = TSinc()
        self.first_bn = tnn.BatchNorm1d(128)
        plan = [(128, 128), (128, 128), (128, 256), (256, 256), (256, 256), (256, 256)]
        for i, (a, b) in enumerate(plan):
            setattr(self, f"block{i}", TRawBlock(a, b, first=(i == 0)))
            setattr(self, f"fc_attention{i}", tnn.Linear(b, b))
        self.bn_before_gru = tnn.BatchNorm1d(256)
        self.gru = tnn.GRU(256, 1024, num_layers=gru_layers, batch_first=True)
        self.fc1_gru = tnn.Linear(1024, 1024)
        if fmsl:
            self.fmsl_system = TFMSL(1024)
        else:
            self.fc2_gru = tnn.Linear(1024, 2)

    def forward(self, x):
        h = self.Sinc_conv(x.unsqueeze(1))
        h = tF.selu(self.first_bn(tF.max_pool1d(torch.abs(h), 3)))
        for i in range(6):
            hi = getattr(self, f"block{i}")(h)
            y = torch.sigmoid(getattr(self, f"fc_attention{i}")(hi.mean(dim=2)))
            h = hi * y.unsqueeze(-1) + y.unsqueeze(-1)
        h = tF.selu(self.bn_before_gru(h))
        out, _ = self.gru(h.permute(0, 2, 1))
        feat = self.fc1_gru(out[:, -1, :])
        if hasattr(self, "fmsl_system"):
            return self.fmsl_system.am_logits(feat, 32.0)
        return tF.log_softmax(self.fc2_gru(feat), dim=-1)


@torch.no_grad()
def randomize(model: tnn.Module, generator: torch.Generator) -> tnn.Module:
    """Draw every weight and BatchNorm statistic of ``model`` from
    ``generator`` (on the CPU), as torch's default initialisers would: a
    conv's or linear's weight and bias uniform in +-1/sqrt(fan_in), a GRU's in
    +-1/sqrt(hidden); BN scale 1 + 0.1 N, bias 0.1 N, running mean 0.5 N and
    variance uniform in [0.5, 2.5); the FMSL prototypes and class weights N,
    its temperature 1. The sinc filters keep their mel-spaced init."""
    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)

    def normal_(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=generator) * std + mean)

    for m in model.modules():
        if isinstance(m, (tnn.Conv1d, tnn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    uniform_(p, bound)
        elif isinstance(m, tnn.GRU):
            for p in m.parameters():
                uniform_(p, 1.0 / math.sqrt(m.hidden_size))
        elif isinstance(m, tnn.BatchNorm1d):
            normal_(m.weight, 0.1, 1.0)
            normal_(m.bias, 0.1)
            normal_(m.running_mean, 0.5)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=generator) * 2 + 0.5)
        elif isinstance(m, TFMSL):
            normal_(m.prototypes, 1.0)
            normal_(m.weight, 1.0)
            m.temperature.fill_(1.0)
    return model
