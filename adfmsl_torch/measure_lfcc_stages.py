"""Where kernel K4's time goes inside a CTA, phase by phase.

    python -m adfmsl_torch.measure_lfcc_stages [--batch 128] [--precision high]

Builds ``csrc/lfcc_fused.cu`` with ``-DLFCC_STAGE_STAMPS`` (its ``STAMP``
points write ``clock64()`` at the tensor-core engine's phase boundaries; the
library the port runs is built without them), launches it at the model's
front-end shape (cut 64600, hop 160, win 400, n_fft 512, 70 filters, 60
coefficients), and prints one JSON object: for each phase the median over the
warpgroup tiles of its cycles, with the kernel's time (CUDA events), the
card's name, power limit and SM clock. The phases, per warpgroup: staging the
tile's samples; each chunk's products (with the previous chunk's filterbank
pass, which runs under them); each chunk's power stage; the last chunk's
filterbank pass; the log; the DCT's wait at the CTA barrier, its copy of the
DCT matrix and its products; the store. The stamps cost a few instructions a
phase. A diagnostic for K4's design: it needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from adfmsl_torch.device import resolve_device
from adfmsl_torch.ops import _build
from adfmsl_torch.ops import lfcc_fused as lf

SLOTS = 40          # stamps a tile (csrc/lfcc_fused.cu: STAMP_SLOTS)
MAX_CHUNKS = 16     # chunks stamped (slots 8 + 2c and 9 + 2c)
CUT, HOP, WIN, N_FFT, SR, N_FILTER, N_LFCC = 64600, 160, 400, 512, 16000, 70, 60


def build() -> ctypes.CDLL:
    """The stamped variant of the K4 library."""
    dll = _build.load_library("lfcc_fused", ("LFCC_STAGE_STAMPS",))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.lfcc_fused_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                      ctypes.c_float, i, i, p]
    dll.lfcc_stamps.argtypes = [ctypes.POINTER(ctypes.c_longlong), i]
    return dll


def measure(batch: int, precision: str, device: torch.device) -> dict:
    dll = build()
    x = torch.randn((batch, CUT), generator=torch.Generator(device=device).manual_seed(0),
                    device=device)
    ops = lf.kernel_operands(SR, N_FFT, WIN, N_FILTER, N_LFCC, precision, device)
    n_frames = 1 + CUT // HOP
    out = torch.empty((batch, n_frames, N_LFCC), device=device)
    p = ctypes.c_void_p

    def launch():
        rc = dll.lfcc_fused_launch(
            p(x.data_ptr()), p(ops.w.data_ptr()), p(ops.fb.data_ptr()),
            p(ops.fb_index.data_ptr()), p(ops.dct.data_ptr()), p(out.data_ptr()), batch,
            CUT, HOP, WIN, ops.n_chunks, N_FILTER, N_LFCC, ops.fb.numel(),
            ctypes.c_float(1e-6), lf.MODES[precision], device.index or 0,
            p(torch.cuda.current_stream(device).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    for _ in range(3):
        launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    want = lf.lfcc_fused_plain(x, precision=precision)
    err = (out - want).abs().max().item() / (1e-4 * want.abs().max().item())
    n_wg = batch * -(-n_frames // lf.TILE_FRAMES)
    buf = (ctypes.c_longlong * (n_wg * SLOTS))()
    if dll.lfcc_stamps(buf, n_wg * SLOTS) != 0:
        raise RuntimeError("reading the stamps failed")
    st = np.frombuffer(buf, dtype=np.int64).reshape(n_wg, SLOTS).astype(np.float64)
    nc = min(ops.n_chunks, MAX_CHUNKS)
    med = lambda v: float(np.median(v))  # noqa: E731
    chunk_start = [st[:, 1]] + [st[:, 9 + 2 * c] for c in range(nc - 1)]
    products = [med(st[:, 8 + 2 * c] - chunk_start[c]) for c in range(nc)]
    power = [med(st[:, 9 + 2 * c] - st[:, 8 + 2 * c]) for c in range(nc)]
    phases = {"staging": med(st[:, 1] - st[:, 0]),
              "products_with_previous_filterbank": products, "power": power,
              "last_filterbank": med(st[:, 2] - st[:, 9 + 2 * (nc - 1)]),
              "log": med(st[:, 3] - st[:, 2]), "dct_wait": med(st[:, 4] - st[:, 3]),
              "dct_copy": med(st[:, 5] - st[:, 4]), "dct_products": med(st[:, 6] - st[:, 5]),
              "store": med(st[:, 7] - st[:, 6]), "total": med(st[:, 7] - st[:, 0])}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"batch": batch, "precision": precision, "kernel_ms": start.elapsed_time(end),
            "max_err_over_tol": err, "warpgroups": n_wg, "cycles": phases,
            "products_cycles_sum": sum(products), "power_cycles_sum": sum(power),
            "device": torch.cuda.get_device_name(device), "nvidia_smi": smi.strip()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--precision", choices=["high", "default"], default="high")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    print(json.dumps(measure(args.batch, args.precision, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
