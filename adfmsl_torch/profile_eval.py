"""Where the time of one eval forward goes, on the card.

    python -m adfmsl_torch.profile_eval [--model maze5|main|lcnn1d_lfcc|...]
        [--batch 128] [--cut 64600] [--fused_frontend] [--no_fused_trunk]

Builds the model as the evaluate CLI does (random weights from ``--seed``, the
folded K1 trunk unless ``--no_fused_trunk``, the K3 front end of a RawNet model
with ``--fused_frontend`` at batches of at most 16), runs a few warm forwards
on random audio, then prints one JSON line per section:

- ``stages``: CUDA-event time of each top-level stage of one forward (the sinc
  front end, each trunk block, for RawNet models the GRU and fc1_gru, the
  head), and the rest (front-end BN/SELU, gates, pooling) as glue; for the
  LFCC / log-mel models (``lcnn_lfcc``, ``lcnn1d_lfcc``, ``resnet18_logmel``)
  the front end (DSP and CMVN), the trunk (to the pooled features) and the
  head;
- ``kernels``: the device time by kernel name over ``--reps`` forwards from
  ``torch.profiler`` (top 12), with the device busy share of the window.
"""
from __future__ import annotations

import argparse
import json
import time

import torch


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
    else:
        names = ["sinc"] + [f"trunk.block{i}" for i in range(model.trunk.n_blocks)]
    return names + [n for n in ("fc1", "fmsl", "fc2") if hasattr(model, n)]


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
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.key, ev.self_device_time_total / 1e3 / reps,
                         ev.count // reps))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms_per_forward": wall_ms / reps, "device_ms_per_forward": busy,
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
        print("kernels " + json.dumps({**head, **kernel_times(model, x, args.reps)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
