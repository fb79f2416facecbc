"""PyTorch/CUDA port of the BLITZSCALE reproduction.

A second package beside ``repro`` (the JAX reference).  It keeps the JAX
package's module names and public layouts so that the parity tests compare
like with like, runs on an NVIDIA Hopper GPU through hand-written CUDA
kernels (``repro_torch.kernels``), and imports nothing from ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; asking
for CUDA on a machine without it raises (see :mod:`repro_torch.device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
