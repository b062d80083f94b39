"""JSONL telemetry sink and run manifest (the port of
``repro.obs.sink``).

Every emitter stamps its output with :func:`run_manifest` (git SHA,
config hash, platform, PyTorch and CUDA versions, the device), so a
telemetry file can be joined with another measurement taken under the
same knobs.  :func:`config_hash` of a port ``FLConfig`` equals the
reference's for the same values.

File format — one JSON object per line, discriminated by ``type``:

    {"type": "manifest", ...}          # first line, always
    {"type": "round", "round": 0, ...} # one per flushed RoundTelemetry
    {"type": "spans", ...}             # StageTrace summary (optional)
    {"type": "metrics", ...}           # MetricsRegistry snapshot (optional)

Read back with :func:`read_jsonl`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform as _platform
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as _np
import torch


def _json_safe(x: Any) -> Any:
    if isinstance(x, (_np.floating, _np.integer)):
        return x.item()
    if isinstance(x, _np.bool_):
        return bool(x)
    if isinstance(x, _np.ndarray):
        return x.tolist()
    if isinstance(x, float) and x != x:      # NaN -> null (strict JSON)
        return None
    raise TypeError(f'not JSON-serializable: {type(x)}')


def git_sha(cwd: Optional[str] = None) -> str:
    """The short commit of the checkout (of ``cwd`` if given, else the
    one holding this file); 'unknown' outside a git checkout."""
    for d in filter(None, (cwd, os.path.dirname(os.path.abspath(__file__)))):
        try:
            return subprocess.check_output(
                ['git', 'rev-parse', '--short', 'HEAD'], cwd=d, text=True,
                stderr=subprocess.DEVNULL).strip()
        except Exception:
            continue
    return 'unknown'


def config_hash(cfg: Any) -> Optional[str]:
    """Stable digest of a (frozen dataclass) config."""
    if cfg is None:
        return None
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    blob = json.dumps(cfg, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def run_manifest(fl: Any = None, extra: Optional[Dict[str, Any]] = None,
                 device: Optional[torch.device] = None,
                 mesh: Any = None) -> Dict[str, Any]:
    """The run's provenance; ``device`` is the run's (default: the first
    CUDA card if there is one, else the CPU); ``mesh`` the client mesh of
    a sharded run (``core.mesh.ClientMesh``: its shape, ranks and
    backend), else None."""
    if device is None:
        device = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    device = torch.device(device)
    man: Dict[str, Any] = {
        'date': time.strftime('%Y-%m-%dT%H:%M:%S'),
        'git_sha': git_sha(),
        'config_hash': config_hash(fl),
        'config': dataclasses.asdict(fl)
        if dataclasses.is_dataclass(fl) else None,
        'platform': {
            'system': _platform.platform(),
            'machine': _platform.machine(),
            'python': _platform.python_version(),
        },
        'torch': {
            'version': torch.__version__,
            'cuda': torch.version.cuda,
            'device': (torch.cuda.get_device_name(device)
                       if device.type == 'cuda' else device.type),
            'device_count': torch.cuda.device_count(),
        },
        'mesh': None if mesh is None else {
            'shape': {'data': int(mesh.size)},
            'n_devices': int(mesh.size),
            'backend': mesh.backend,
        },
    }
    if extra:
        man.update(extra)
    return man


MANIFEST_KEYS = ('date', 'git_sha', 'config_hash', 'platform', 'torch',
                 'mesh')


class JsonlSink:
    """Append-per-line telemetry writer; the manifest is always line 0."""

    def __init__(self, path: str,
                 manifest: Optional[Dict[str, Any]] = None) -> None:
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, 'w')
        self.rounds = 0
        if manifest is not None:
            self._emit({'type': 'manifest', **manifest})

    def _emit(self, obj: Dict[str, Any]) -> None:
        self._f.write(json.dumps(obj, default=_json_safe) + '\n')
        self._f.flush()

    def write_round(self, row: Dict[str, Any]) -> None:
        if row.get('round') is None:
            row = dict(row, round=self.rounds)
        self._emit({'type': 'round', **row})
        self.rounds += 1

    def write_spans(self, summary: Dict[str, Any]) -> None:
        self._emit({'type': 'spans', 'spans': summary})

    def write_metrics(self, snapshot: Dict[str, Any]) -> None:
        self._emit({'type': 'metrics', 'metrics': snapshot})

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> 'JsonlSink':
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> Tuple[Optional[Dict[str, Any]],
                                   List[Dict[str, Any]]]:
    """-> (manifest or None, [round rows, oldest first]).  Other line
    types (spans, metrics) are skipped; use json directly for those."""
    manifest = None
    rows: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if obj.get('type') == 'manifest' and manifest is None:
                manifest = obj
            elif obj.get('type') == 'round':
                rows.append(obj)
    return manifest, rows
