"""Computation-environment hygiene: platform, precision and the
process-wide settings that move a step (the port of
``repro.launch.env``).

Before a driver touches the card, :func:`configure` pins what it can
and records what it resolved, and :func:`resolved_state` adds the live
view; ``obs.sink.run_manifest`` embeds the latter as its ``'env'`` block,
so two runs' records say whether they ran under the same settings.

Environment overrides (all optional): ``REPRO_PLATFORM`` (gpu|cuda|cpu;
'tpu' raises: the port runs on a CUDA card, or on the CPU only when
that is asked for), ``REPRO_X64`` (0|1, else ``JAX_ENABLE_X64``: float64
as torch's default float dtype) and ``REPRO_HOST_DEVICES`` (int: recorded
only; no flag forces host devices here, a mesh is made of processes).

Besides those, the record holds the settings that changed a step's
numbers or time in this port: the cuBLAS workspace
(``CUBLAS_WORKSPACE_CONFIG``, which deterministic algorithms need before
the process's first cuBLAS call: :func:`pin_cublas_workspace`),
deterministic algorithms, TF32 on matmul and on cuDNN, the float32
matmul precision, cuDNN's benchmark and deterministic flags, the
intra-op and inter-op threads, and the torch and CUDA versions and the
card's name.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

PLATFORMS = {'gpu': 'gpu', 'cuda': 'gpu', 'cpu': 'cpu'}
# the cuBLAS workspace torch.use_deterministic_algorithms asks for
CUBLAS_WORKSPACE_CONFIG = ':4096:8'

# what configure() resolved this process to: the manifest's 'env' block
_STATE: Dict[str, Any] = {'configured': False}


def set_platform(platform: Optional[str] = None) -> str:
    """The platform of the run: ``platform``, else ``REPRO_PLATFORM``,
    else 'gpu' (the card).  -> 'gpu' or 'cpu'; 'tpu' and anything else
    raise ``ValueError``."""
    name = (platform or os.environ.get('REPRO_PLATFORM') or 'gpu').lower()
    if name not in PLATFORMS:
        raise ValueError(f'platform {name!r}: the port runs on gpu (cuda) '
                         'or, when asked, cpu')
    return PLATFORMS[name]


def enable_x64(use_x64: Optional[bool] = None) -> bool:
    """torch's default float dtype: float64 when ``use_x64`` (unset:
    ``REPRO_X64``, else ``JAX_ENABLE_X64``, '1'), else float32."""
    if use_x64 is None:
        use_x64 = os.environ.get(
            'REPRO_X64', os.environ.get('JAX_ENABLE_X64', '0')) == '1'
    torch.set_default_dtype(torch.float64 if use_x64 else torch.float32)
    return bool(use_x64)


def set_host_device_count(n: Optional[int] = None) -> Optional[int]:
    """``n``, else ``REPRO_HOST_DEVICES``, else None: recorded, nothing
    forced (a port mesh is a process group of that many ranks)."""
    if n is None:
        raw = os.environ.get('REPRO_HOST_DEVICES')
        n = int(raw) if raw else None
    return n


def pin_cublas_workspace() -> str:
    """``CUBLAS_WORKSPACE_CONFIG`` as deterministic algorithms need it
    (kept if already set) -> its value.  It takes effect only before the
    process's first cuBLAS call."""
    return os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG',
                                 CUBLAS_WORKSPACE_CONFIG)


def configure(platform: Optional[str] = None,
              use_x64: Optional[bool] = None,
              host_device_count: Optional[int] = None) -> Dict[str, Any]:
    """Apply the hygiene pass and record what was resolved.  Safe to call
    more than once (later calls re-record)."""
    _STATE.update(
        configured=True,
        platform=set_platform(platform),
        x64=enable_x64(use_x64),
        host_device_count=set_host_device_count(host_device_count),
    )
    return dict(_STATE)


def configure_driver(args) -> Dict[str, Any]:
    """:func:`configure` at the top of a driver's ``main`` (``args`` with
    a ``device`` field): the platform 'cpu' where ``--device cpu`` asks
    for it; a ``REPRO_PLATFORM=cpu`` override with no ``--device`` sets
    ``args.device`` to 'cpu'."""
    state = configure(platform='cpu' if args.device == 'cpu' else None)
    if args.device is None and state['platform'] == 'cpu':
        args.device = 'cpu'
    return state


def settings() -> Dict[str, Any]:
    """The live process-wide settings that move a step."""
    cuda = torch.cuda.is_available()
    return {
        'default_dtype': str(torch.get_default_dtype()),
        'cublas_workspace_config': os.environ.get('CUBLAS_WORKSPACE_CONFIG'),
        'deterministic_algorithms':
            torch.are_deterministic_algorithms_enabled(),
        'deterministic_warn_only':
            torch.is_deterministic_algorithms_warn_only_enabled(),
        'tf32_matmul': bool(torch.backends.cuda.matmul.allow_tf32),
        'tf32_cudnn': bool(torch.backends.cudnn.allow_tf32),
        'float32_matmul_precision': torch.get_float32_matmul_precision(),
        'cudnn_benchmark': bool(torch.backends.cudnn.benchmark),
        'cudnn_deterministic': bool(torch.backends.cudnn.deterministic),
        'intra_op_threads': torch.get_num_threads(),
        'inter_op_threads': torch.get_num_interop_threads(),
        'torch': torch.__version__,
        'cuda': torch.version.cuda,
        'device_name': torch.cuda.get_device_name(0) if cuda else 'cpu',
        'device_count': torch.cuda.device_count(),
    }


def resolved_state() -> Dict[str, Any]:
    """The recorded :func:`configure` outcome plus the live settings:
    what the run manifest embeds."""
    state = dict(_STATE)
    state.update(settings())
    state['x64_enabled'] = torch.get_default_dtype() == torch.float64
    return state
