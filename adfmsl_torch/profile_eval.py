"""Where the time of one eval forward goes, on the card.

    python -m adfmsl_torch.profile_eval [--model maze5|main|lcnn1d_lfcc|...]
        [--batch 128] [--cut 64600] [--fused_frontend] [--no_fused_trunk]

Builds the model as the evaluate CLI does (random weights from ``--seed``, the
folded K1 trunk unless ``--no_fused_trunk``, the K3 front end of a RawNet model
with ``--fused_frontend`` at batches of at most 16), runs a few warm forwards
on random audio, then prints one JSON line per section:

- ``stages``: CUDA-event time of each top-level stage of one forward (the sinc
  front end, or the Wav2Vec2 encoder's conv layers, positional conv and
  transformer layers, the 1x1 ``proj`` conv (maze6's fusion of five taps) and
  maze8's conv FMSL layer; each trunk block; the layers of the transformer
  after the trunk and the attentive-stats pooling; for RawNet models the GRU
  and fc1_gru; the head), and the rest (input normalisation, feature
  projection and LayerNorms, the taps' concatenation, front-end BN/SELU,
  gates, the BN before the transformer, mean pooling) as glue; for the
  LFCC / log-mel models (``lcnn_lfcc``, ``lcnn1d_lfcc``, ``resnet18_logmel``)
  the front end (DSP and CMVN), the trunk (to the pooled features) and the
  head;
- ``stages_profiler``: the device time of the coarse stages (the front end,
  the ``proj`` conv and conv FMSL layer where the model has them, the trunk,
  the transformer and the ASP pooling where it has them, the head) from
  ``torch.profiler`` over ``--reps`` forwards: each
  stage a ``record_function`` range, timed by the union of the intervals of
  the kernels inside its device-side spans (the profiler emits several,
  overlapping, for one range, and a span also holds the gaps between its
  kernels); the forward's device time is the union of its kernels' intervals
  (cuDNN runs a grouped conv's groups as concurrent kernels, so summing kernel
  times would count that time twice), with the device busy share of the window;
- ``kernels``: the device time by kernel name over ``--reps`` forwards from
  ``torch.profiler`` (top 12), with the forward's device time (the union of
  its kernels' intervals) and the device busy share of the window.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from adfmsl_torch.utils.profiling import is_span


def build(model_name: str, args, device: torch.device):
    from adfmsl_torch.cli.evaluate import set_fused_extras
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import SPECS, build_model

    exp = make_experiment(model_name)
    if model_name in SPECS:
        set_fused_extras(exp, SPECS[model_name], fused_frontend=args.fused_frontend,
                         fused_trunk=not args.no_fused_trunk)
    return build_model(exp.model, device=device, seed=args.seed)


def stage_names(model) -> list:
    """The top-level stages of a forward, by module name."""
    if hasattr(model, "encoder"):                            # RawNet
        enc = model.encoder
        names = (["encoder.sinc"] + [f"encoder.block{i}" for i in range(enc.n_blocks)]
                 + ["encoder.gru", "encoder.fc1_gru"])
    elif hasattr(model, "wav2vec2"):
        enc = model.wav2vec2
        names = ([f"wav2vec2.feature_extractor.conv_layers_{i}"
                  for i in range(enc.feature_extractor.n)] + ["wav2vec2.pos_conv_embed"]
                 + [f"wav2vec2.layers_{i}" for i in range(enc.arch.num_layers)]
                 + _present(model, "proj", "conv_fmsl")
                 + [f"trunk.block{i}" for i in range(model.trunk.n_blocks)]
                 + [f"transformer.layer{i}" for i in range(
                     model.transformer.n_layers if hasattr(model, "transformer") else 0)]
                 + _present(model, "asp"))
    else:
        names = ["sinc"] + [f"trunk.block{i}" for i in range(model.trunk.n_blocks)]
    return names + head_names(model)


def _present(model, *names) -> list:
    return [n for n in names if hasattr(model, n)]


def head_names(model) -> list:
    return _present(model, "fc1", "fmsl", "fc2")


def coarse_stage_names(model) -> list:
    """The front end, the trunk and the head, by module name."""
    if hasattr(model, "encoder"):
        return ["encoder"] + head_names(model)
    if hasattr(model, "wav2vec2"):
        return (["wav2vec2"] + _present(model, "proj", "conv_fmsl") + ["trunk"]
                + _present(model, "transformer", "asp") + head_names(model))
    return ["sinc", "trunk"] + head_names(model)


def union_ms(intervals) -> float:
    """Total length (ms) of the union of (start, end) intervals in us."""
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return (total + (cur[1] - cur[0] if cur else 0.0)) / 1e3


def spectral_stage_times(model, x) -> dict:
    """CUDA-event time (ms) of the front end, trunk and head of one forward of
    an LFCC / log-mel model (``models/lcnn.py:SpectralModel``)."""
    stages = (("frontend", model.features), ("trunk", model.trunk), ("head", model.head))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
    h = x
    events[0].record()
    for (_, fn), ev in zip(stages, events[1:]):
        h = fn(h)
        ev.record()
    torch.cuda.synchronize()
    out = {n: events[i].elapsed_time(events[i + 1]) for i, (n, _) in enumerate(stages)}
    out["forward"] = events[0].elapsed_time(events[-1])
    return out


def stage_times(model, x) -> dict:
    """CUDA-event time (ms) of each top-level module call in one forward."""
    if hasattr(model, "classify"):
        return spectral_stage_times(model, x)
    names = stage_names(model)
    mods = dict(model.named_modules())
    events, handles = {}, []
    for n in names:
        def pre(_m, _a, n=n):
            events[n] = [torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True)]
            events[n][0].record()

        def post(_m, _a, _o, n=n):
            events[n][1].record()
        handles += [mods[n].register_forward_pre_hook(pre),
                    mods[n].register_forward_hook(post)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        model(x)
        end.record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {n: events[n][0].elapsed_time(events[n][1]) for n in names}
    out["forward"] = start.elapsed_time(end)
    out["glue"] = out["forward"] - sum(out[n] for n in names)
    return out


def stage_device_times(model, x, reps: int, names=None) -> dict:
    """Device ms per forward of each stage (``names``, by default
    ``coarse_stage_names``) from ``torch.profiler``: each stage a
    ``record_function`` range entered and left by forward hooks, measured by
    the union of the kernel intervals inside its device-side spans; the
    forward's device ms is the union of its kernels' intervals; with the busy
    share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    names = names or coarse_stage_names(model)
    mods = dict(model.named_modules())
    open_ranges, handles = {}, []
    for n in names:
        def pre(_m, _a, n=n):
            open_ranges[n] = record_function(f"stage.{n}")
            open_ranges[n].__enter__()

        def post(_m, _a, _o, n=n):
            open_ranges.pop(n).__exit__(None, None, None)
        handles += [mods[n].register_forward_pre_hook(pre),
                    mods[n].register_forward_hook(post)]
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for h in handles:
            h.remove()
    # device events: the kernels and copies, and the ranges' device-side spans
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [(e.time_range.start, e.time_range.end) for e in on_device
               if not is_span(e.key)]
    device = union_ms(kernels) / reps
    out = {}
    for n in names:
        spans = [(e.time_range.start, e.time_range.end) for e in on_device
                 if e.key == f"stage.{n}"]
        out[n] = union_ms((max(s, a), min(e, b)) for s, e in kernels for a, b in spans
                          if min(e, b) > max(s, a)) / reps
    out["device_ms_per_forward"] = device
    out["rest"] = device - sum(out[n] for n in names)
    out["device_busy_share"] = device * reps / wall_ms if wall_ms else None
    return out


def kernel_times(model, x, reps: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            model(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():           # device events only: no double count
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not is_span(ev.key)):
            rows.append((ev.key, ev.self_device_time_total / 1e3 / reps,
                         ev.count // reps))
    rows.sort(key=lambda r: -r[1])
    # concurrent kernels (a grouped conv's groups) count once in the union
    busy = union_ms((e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.device_type == DeviceType.CUDA and not is_span(e.key)) / reps
    return {"wall_ms_per_forward": wall_ms / reps, "device_ms_per_forward": busy,
            "kernel_ms_sum_per_forward": sum(r[1] for r in rows),
            "device_busy_share": busy * reps / wall_ms if wall_ms else None,
            "top": [{"kernel": k[:90], "ms": ms, "calls": c} for k, ms, c in rows[:12]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("adfmsl_torch.profile_eval")
    p.add_argument("--model", default="maze5")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--cut", type=int, default=64600)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fused_frontend", action="store_true")
    p.add_argument("--no_fused_trunk", action="store_true")
    args = p.parse_args(argv)

    from adfmsl_torch.device import resolve_device

    dev = resolve_device("cuda")
    model = build(args.model, args, dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    x = 0.1 * torch.randn((args.batch, args.cut), generator=g, device=dev)
    head = {"model": args.model, "batch": args.batch, "cut": args.cut,
            "fused_trunk": not args.no_fused_trunk,
            "fused_frontend": args.fused_frontend,
            "device": torch.cuda.get_device_name(0)}
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        print("stages " + json.dumps({**head, **stage_times(model, x)}), flush=True)
        print("stages_profiler " + json.dumps(
            {**head, **stage_device_times(model, x, args.reps)}), flush=True)
        print("kernels " + json.dumps({**head, **kernel_times(model, x, args.reps)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
