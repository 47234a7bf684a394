"""Time kernel K2 (the BN + ReLU train backward) against plain autograd.

    python -m adfmsl_torch.measure_bn_relu_bwd [b16|b128|both]

K2's entry point, as ``scripts/measure_bn_relu_bwd.py`` (:30-106) is adfmsl's:
maze5's block0 shapes in bf16, (16, 64350, 128) at batch 16 and
(128, 21450, 128) at batch 128. Four programs, each a forward plus a backward
with a fixed random cotangent:

  A_plain       BN(train) -> ReLU in plain torch ops (the forward's math), autograd
  B_kernel      ``bn_relu_train``: the same forward, K2's one-launch backward
  A_plain_conv  A followed by a k3 bf16 conv, its real consumer in the trunk
  B_kernel_conv B followed by the same conv

Each is timed with CUDA events over ``ITERS`` runs after two warm ones, and
the script prints one JSON object of milliseconds per run, with the card's
name. It runs on the card; a missing card raises.
"""
from __future__ import annotations

import json
import sys
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from adfmsl_torch.device import resolve_device
from adfmsl_torch.ops.bn_relu_bwd import bn_relu_forward, bn_relu_train

ITERS = 20
SHAPES = {"b16": (16, 64350, 128), "b128": (128, 21450, 128)}


def _time_ms(fn: Callable[[], None], iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(b: int, t: int, c: int, device: torch.device, iters: int = ITERS
            ) -> Dict[str, float]:
    """Milliseconds per forward + backward of the four programs at (b, t, c)."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((b, t, c), generator=g, device=device).to(torch.bfloat16)
    gamma = torch.empty(c, device=device).uniform_(0.5, 1.5, generator=g)
    beta = torch.empty(c, device=device).uniform_(-0.3, 0.3, generator=g)
    ct = torch.randn((b, t, c), generator=g, device=device).to(torch.bfloat16)
    w = (0.05 * torch.randn((c, c, 3), generator=g, device=device)).to(torch.bfloat16)
    leaves = [x.requires_grad_(True), gamma.requires_grad_(True), beta.requires_grad_(True)]

    def plain(a, gm, bt):
        return bn_relu_forward(a, gm, bt)[0]

    def kernel(a, gm, bt):
        return bn_relu_train(a, gm, bt)

    def with_conv(f):
        def run(a, gm, bt):
            h = f(a, gm, bt)
            return F.conv1d(h.transpose(1, 2), w, padding=1).transpose(1, 2)
        return run

    def program(f):
        def run():
            y = f(*leaves)
            torch.autograd.grad(y, leaves, ct)
        return run

    return {"A_plain": _time_ms(program(plain), iters),
            "B_kernel": _time_ms(program(kernel), iters),
            "A_plain_conv": _time_ms(program(with_conv(plain)), iters),
            "B_kernel_conv": _time_ms(program(with_conv(kernel)), iters)}


def run(which: str = "both", iters: int = ITERS) -> Dict[str, object]:
    dev = resolve_device(None)
    names: Sequence[str] = list(SHAPES) if which == "both" else [which]
    if any(n not in SHAPES for n in names):
        raise ValueError(f"choose b16, b128 or both, not {which!r}")
    results: Dict[str, object] = {"device": torch.cuda.get_device_name(dev)}
    for n in names:
        b, t, c = SHAPES[n]
        results[f"{n}_block0_({b},{t},{c})"] = measure(b, t, c, dev, iters)
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    print(json.dumps(run(argv[0] if argv else "both")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
