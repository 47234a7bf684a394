"""Activation checkpointing with ``jax.checkpoint``'s semantics (the port's
counterpart of adfmsl's ``train.remat``, ``adfmsl/train/steps.py:82-86``, and
of the Wav2Vec2 encoder's ``nn.remat``, ``adfmsl/models/w2v2.py:169-184``).

``checkpoint(fn, *args, generators=...)`` runs ``fn`` through
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the forward
keeps only its inputs, and the backward runs ``fn`` again to rebuild what it
needs. The non-reentrant form is the one that gives parameter gradients when
no input requires grad (the audio never does). Two things a recompute must not
change, which ``jax.checkpoint`` gets for free from pure functions:

- the BN running statistics. ``ops/norm.py:bn_train`` moves them in place on
  every call; in JAX the mutated ``batch_stats`` come from the first forward
  alone. While a recompute runs, ``recomputing()`` is true on its thread (the
  backward's thread on the card) and ``bn_train`` leaves the buffers alone;
  it still normalises with the batch statistics;
- the explicit ``torch.Generator`` streams ('dropout', 'specaugment', 'lsa'),
  which ``torch.utils.checkpoint``'s ``preserve_rng_state`` does not cover.
  The forward records each generator's state on entry; the recompute sets
  those states, runs, and puts back the states it found. The masks are the
  same, and every generator ends the step where a plain step leaves it.

Outside autograd (``torch.no_grad``, inference) ``fn`` runs plainly.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterable, Mapping, Optional

import torch
import torch.utils.checkpoint as tcp

_local = threading.local()


def recomputing() -> bool:
    """True on the thread that is rerunning a checkpointed forward."""
    return getattr(_local, "recomputing", False)


@contextlib.contextmanager
def _recompute_flag():
    prev = recomputing()
    _local.recomputing = True
    try:
        yield
    finally:
        _local.recomputing = prev


def _contexts(gens: Iterable[torch.Generator]):
    """The (forward, recompute) context pair of one checkpointed call."""
    gens = list(gens)
    at_entry: list = []

    @contextlib.contextmanager
    def forward():
        at_entry[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        found = [g.get_state() for g in gens]
        for g, s in zip(gens, at_entry):
            g.set_state(s)
        try:
            with _recompute_flag():
                yield
        finally:
            for g, s in zip(gens, found):
                g.set_state(s)

    return forward(), recompute()


def checkpoint(fn: Callable[..., Any], *args: Any,
               generators: Optional[Mapping[str, Optional[torch.Generator]]] = None,
               **kwargs: Any) -> Any:
    """``fn(*args, **kwargs)``, checkpointed where autograd records it.

    ``generators`` maps names to the generators ``fn`` draws from (a model
    forward's ``rngs``); their draws replay in the recompute."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    gens = [g for g in (generators or {}).values() if g is not None]
    return tcp.checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: _contexts(gens), **kwargs)
