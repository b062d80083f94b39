"""PyTorch + CUDA port of the SP-FL system (``repro``, JAX + Pallas).

The layout mirrors ``repro`` module for module so each counterpart is easy
to find.  The package imports ``torch`` and ``numpy`` only: nothing of
JAX and nothing of ``repro`` (``tests/test_torch_isolation.py`` guards
this).  Entry points run on the CUDA card unless the caller passes
``device='cpu'`` (``repro_torch.device.resolve``); on the CPU every kernel
wrapper in ``repro_torch.kernels.ops`` takes its plain PyTorch version.
"""
from repro_torch.device import resolve  # noqa: F401
