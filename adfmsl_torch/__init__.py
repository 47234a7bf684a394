"""adfmsl_torch: the PyTorch/CUDA port of adfmsl for NVIDIA Hopper.

A second package beside the JAX reference (``adfmsl``): it imports torch,
numpy, scipy and pyyaml (matplotlib only for the analysis figures, lazily),
never JAX and nothing of ``adfmsl``. Public functions
keep adfmsl's (B, T, C) channels-last layout so the parity tests compare like
with like. Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``.
"""
from adfmsl_torch.device import resolve_device

__all__ = ["resolve_device"]
