"""Start N local ranks over ``torch.distributed`` (adfmsl is single-process
and has no counterpart; torch runs one process per rank).

``launch(fn, nprocs, args)`` spawns the ranks (the spawn start method: CUDA
cannot fork), joins them through a ``file://`` rendezvous in a fresh
temporary directory (no ports), calls ``fn(device, *args)`` in each and
returns their return values in rank order. Rank ``r`` runs on
``cuda:{r % device_count}``, or on the CPU when ``device='cpu'``.

- The backend is explicit, ``nccl`` by default. NCCL refuses two ranks on
  one card, so ``nccl`` with more ranks than visible cards raises and names
  ``gloo``, which may share a card (every collective of the port is an
  ``all_reduce`` or a ``broadcast``, both of which gloo runs on CUDA tensors).
  No backend is switched silently.
- The CUDA libraries are built before the ranks start, so no two ranks race
  to build into ``adfmsl_torch/_build/``.
- A rank that raises fails the launch with its traceback; the other ranks are
  killed. A collective that waits longer than ``collective_timeout`` seconds
  fails its rank, so a hung collective fails the launch instead of hanging
  it. ``timeout`` (seconds, ``None``: none) limits the whole launch: past it
  every rank is killed and the launch raises ``TimeoutError``. The CLIs set
  none, since a training run may take days; tests set one.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from adfmsl_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")
COLLECTIVE_TIMEOUT = 1800.0      # seconds a collective may wait for its peers


def kernel_launches() -> Dict[str, int]:
    """This process's launch counts of the port's CUDA kernels."""
    from adfmsl_torch.ops import (bn_relu_bwd, lfcc_fused, resblock_fused, sinc_fused,
                                  wavlm_attention)

    return {"K1": resblock_fused.resblock_eval.launches,
            "K2": bn_relu_bwd.bn_relu_bwd.launches,
            "K3": sinc_fused.sinc_abs_pool_fused.launches,
            "K3-bwd": sinc_fused.sinc_abs_pool_bwd.launches,
            "K4": lfcc_fused.lfcc_fused.launches,
            "K6": wavlm_attention.wavlm_attention.launches}


def reset_kernel_launches() -> None:
    from adfmsl_torch.ops import (bn_relu_bwd, lfcc_fused, resblock_fused, sinc_fused,
                                  wavlm_attention)

    for f in (resblock_fused.resblock_eval, bn_relu_bwd.bn_relu_bwd,
              sinc_fused.sinc_abs_pool_fused, sinc_fused.sinc_abs_pool_bwd,
              lfcc_fused.lfcc_fused, wavlm_attention.wavlm_attention):
        f.launches = 0


class RankFailed(RuntimeError):
    pass


def _rank_main(rank: int, world: int, init_file: str, backend: str, device: str,
               timeout: float, out_dir: str, fn: Callable[..., Any], args: Sequence) -> None:
    try:
        if device == "cpu":
            dev = torch.device("cpu")
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(dev, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def launch(fn: Callable[..., Any], nprocs: int, args: Sequence = (), *,
           backend: str = "nccl", device: str = "cuda", timeout: Optional[float] = None,
           collective_timeout: float = COLLECTIVE_TIMEOUT) -> List[Any]:
    """Run ``fn(device, *args)`` in ``nprocs`` ranks; their results in rank
    order (each must be picklable by ``torch.save``). ``fn`` must be
    importable by name (a module-level function). ``timeout``: the whole
    launch's limit in seconds (``None``: wait for the ranks);
    ``collective_timeout``: each collective's (never above ``timeout``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if nprocs < 1:
        raise ValueError(f"need at least one rank, got {nprocs}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and nprocs > n_cards:
            raise ValueError(
                f"backend 'nccl' needs a card a rank: {nprocs} ranks, {n_cards} "
                f"visible; ranks may share a card over backend 'gloo'")
        from adfmsl_torch.ops import _build

        _build.build_all()
    elif backend == "nccl":
        raise ValueError("backend 'nccl' runs on CUDA devices; use 'gloo' on the CPU")
    if timeout is not None:
        collective_timeout = min(collective_timeout, timeout)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="adfmsl_launch_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, nprocs, init_file, backend, dev.type,
                                   collective_timeout, tmp, fn, tuple(args)))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks did not finish in {timeout} s")
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        if failed is not None:
            errs = [(r, os.path.join(tmp, f"rank{r}.err")) for r in range(nprocs)]
            text = "".join(f"--- rank {r}:\n{open(e).read()[-4000:]}"
                           for r, e in errs if os.path.exists(e))
            raise RankFailed(f"rank {failed} of {nprocs} exited with code "
                             f"{procs[failed].exitcode}:\n{text}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]
