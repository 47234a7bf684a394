"""Generic name -> factory registry (port of ``adfmsl/utils/registry.py``).

The reference keeps one copy-pasted script per model; here every model
registers into a named registry, so the training and evaluation drivers are
generic (``models/mazes.py:model_registry``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str, obj: Optional[Callable[..., Any]] = None):
        """Register ``obj`` under ``name``; usable as a decorator."""

        def _do(fn: Callable[..., Any]) -> Callable[..., Any]:
            if name in self._entries:
                raise KeyError(f"{self.kind} registry already has '{name}'")
            self._entries[name] = fn
            return fn

        return _do(obj) if obj is not None else _do

    def get(self, name: str) -> Callable[..., Any]:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.kind} '{name}'; known: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def names(self) -> List[str]:
        return sorted(self._entries)
