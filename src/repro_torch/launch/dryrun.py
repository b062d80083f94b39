"""Multi-pod dry run on the meta device (the counterpart of
``repro.launch.dryrun``).

For every (architecture x input shape) and both production meshes, one
rank's step is traced on the ``meta`` device (shapes and dtypes, no
data) inside a fake process group of the mesh's size (256 or 512 ranks;
``torch.testing._internal.distributed.fake_pg``, whose collectives
return at once), with the step builders the card runs:

* ``train_4k``: ``training.distributed.make_fl_train_step`` on the
  production mesh (arctic-480b: ``make_standard_train_step``, its
  experts split over the client axes), on ``FLConfig(n_devices=K)``
  (the analytic wire, the 'gather' collective), K the client ranks;
* ``prefill_32k``: ``models.transformer.prefill`` of the rank's rows;
* ``decode_32k`` and ``long_500k``: one ``decode_step`` of the rank's
  rows against a cache of ``seq_len``;

their inputs are :func:`input_specs` (the reference's), cut to the
rank's blocks by ``launch.shardings``' batch and token specs.

The rank holds its blocks of the parameters, ḡ, the batch and the cache
(``launch.shardings``); a sharded weight or cache leaf is gathered at
use (``training.model_axis``).  Each record holds, under the reference's
keys where they mean the same: ``arch``, ``shape``, ``mesh``,
``applicable``, ``skip_reason``, ``params``, ``active_params``,
``n_layers``, ``n_devices``, ``compile_s`` (here the trace's seconds),
and

* ``memory``: the rank's argument and output bytes from the specs (its
  blocks of the parameters, ḡ, the per-client gradients, the batch and
  the cache), and ``peak_live_bytes``, the port's own reading: the
  arguments plus the most bytes of tensors made during the trace alive
  at once (:class:`LiveBytes`, a dispatch mode), which counts the
  gathered weights and caches, the saved activations and the quantizer
  uniforms (a rank draws each leaf's K rows whole);
* ``cost``: the rank's FLOPs (``torch.utils.flop_counter.FlopCounterMode``:
  matmuls, convolutions and attention, not elementwise work);
* ``collectives``: a count (``CommDebugMode``) and the bytes of the
  results (:class:`LiveBytes`) of each kind the rank issues: all-gather,
  all-reduce, reduce-scatter, all-to-all, send/recv.

The reference extrapolates depth-1 and depth-2 compiles (``hlo_estimate``)
because XLA's cost analysis counts a scanned layer once; the port's
forward is a Python loop over the layers, so the trace counts every
layer and no extrapolation is made.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
      [--single-pod|--multi-pod] [--resume]

Artifacts: ``build/dryrun/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.configs.base import (INPUT_SHAPES, FLConfig, ModelConfig,
                                      ShapeConfig)
from repro_torch.configs.registry import (ARCHITECTURES, applicable,
                                          get_arch, get_shape)
from repro_torch.core import transport as tr
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import (MULTI_POD_AXES, MULTI_POD_SHAPE,
                                     SINGLE_POD_AXES, SINGLE_POD_SHAPE,
                                     ProductionMesh)
from repro_torch.models import transformer as tf
from repro_torch.training import distributed as D
from repro_torch.training import model_axis as MA

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), '..', '..', '..',
                            'build', 'dryrun')
DEVICE_BYTES = 80 * 10 ** 9          # one H100's HBM
FAKE_GROUP = 'torch.testing._internal.distributed.fake_pg (backend "fake")'
KINDS = ('all-gather', 'all-reduce', 'reduce-scatter', 'all-to-all',
         'send/recv')
META = torch.device('meta')


def collective_kind(op_name: str) -> Optional[str]:
    """The kind of a c10d operator (None: not a collective)."""
    if 'c10d' not in op_name:
        return None
    for key, kind in (('allgather', 'all-gather'),
                      ('all_gather', 'all-gather'),
                      ('allreduce', 'all-reduce'),
                      ('all_reduce', 'all-reduce'),
                      ('reduce_scatter', 'reduce-scatter'),
                      ('alltoall', 'all-to-all'),
                      ('all_to_all', 'all-to-all'),
                      ('send', 'send/recv'), ('recv', 'send/recv')):
        if key in op_name:
            return kind
    return None


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for sub in x for t in _tensors(sub)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LiveBytes(TorchDispatchMode):
    """Bytes of the tensors made under the mode that are alive at once
    (a tensor that is no view counts from its making to its release),
    their peak, and each collective's result bytes by kind."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.bytes = {k: 0 for k in KINDS}

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = collective_kind(str(func))
        if kind is not None:
            self.bytes[kind] += sum(_nbytes(t) for t in _tensors(args[0]))
            return out
        for t in _tensors(out):
            if t._is_view() or t._base is not None:
                continue
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


class MetaUniforms(Sequence):
    """The quantizer uniforms of a step on the meta device: item i a
    fresh (K, n_i) float32 tensor, made when the transport asks."""

    def __init__(self, k: int, sizes: Sequence[int]):
        self.k, self.sizes = k, tuple(sizes)

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i: int) -> torch.Tensor:
        return torch.empty((self.k, self.sizes[i]), device=META)


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _blocks(shapes: Dict[str, Tuple[int, ...]], specs, mesh, dtype_of
            ) -> Dict[str, torch.Tensor]:
    return {p: _empty(sh.block_shape(specs[p], s, mesh), dtype_of(p))
            for p, s in shapes.items()}


def _tree_of(like, flat: Dict[str, torch.Tensor]):
    return tree.unflatten(like, [flat[p] for p in tree.paths(like)])


def _bytes(t) -> int:
    return sum(_nbytes(x) for x in tree.leaves(t))


def _without_batch(spec, dim: int) -> tuple:
    return tuple(None if i == dim else e for i, e in enumerate(spec))


def _gather_local(t, spec, mesh, batch_dim: int):
    """A data leaf's block gathered over every sharded dimension but its
    batch dimension (the rank computes on its own rows)."""
    return MA.gather_full(mesh, t, _without_batch(spec, batch_dim))


def _cache_block(t, spec, mesh, batch_dim: int = 1):
    """The rank's block of a cache leaf it holds whole but for the batch."""
    return t[sh.block_slices(_without_batch(spec, batch_dim),
                             tuple(t.shape), mesh, mesh.coords)]


def input_specs(cfg: ModelConfig, shape: ShapeConfig, n_clients: int
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input of this shape, global (the
    reference's ``input_specs``): the client-major training batch
    (arctic-480b: the plain (B, T) batch), the prompt and a vision
    model's prefix embeddings, or one new token against a cache."""
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == 'train':
        if cfg.name.startswith('arctic-480b'):
            return {'tokens': ((b, t), torch.int32)}
        return D.client_batch_shapes(cfg, n_clients, b, t)
    if shape.kind == 'prefill':
        spec = {'tokens': ((b, t), torch.int32)}
        if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
            spec['prefix'] = ((b, cfg.n_prefix_tokens,
                               cfg.frontend_embed_dim), torch.bfloat16)
        return spec
    return {'token': ((b, 1), torch.int32), 'pos': ((), torch.int32)}


class StepTrace:
    """One rank's step of (cfg, shape) on ``mesh``, its inputs made on the
    meta device at the rank's block shapes."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 mesh: ProductionMesh):
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.full = tf.init_params(cfg, torch.Generator(), device=META)
        self.shapes = sh.shapes_of(self.full)
        self.pspecs = sh.param_specs(cfg, mesh, self.full)
        dt = {p: x.dtype for p, x in zip(tree.paths(self.full),
                                         tree.leaves(self.full))}
        self.param_dtype = dt
        self.params = _tree_of(self.full, _blocks(
            self.shapes, self.pspecs, mesh, dt.__getitem__))
        self.k = mesh.clients.size
        self.inputs = input_specs(cfg, shape, self.k)
        self.memory: Dict[str, int] = {'params': _bytes(self.params)}

    def _batch(self, specs) -> Dict[str, torch.Tensor]:
        """The rank's blocks of the inputs under ``specs``."""
        return {f: _empty(sh.block_shape(specs[f], s, self.mesh), d)
                for f, (s, d) in self.inputs.items() if f in specs}

    def arguments(self) -> Tuple[Any, Dict[str, int]]:
        """-> (the step's callable on its meta inputs, the memory record
        of its arguments)."""
        kind = self.shape.kind
        if kind == 'train':
            if self.cfg.name.startswith('arctic-480b'):
                return self._standard()
            return self._fl()
        if kind == 'prefill':
            return self._prefill()
        return self._decode()

    # -- steps ---------------------------------------------------------------

    def _fl(self):
        cfg, shape, mesh, k = self.cfg, self.shape, self.mesh, self.k
        fl = FLConfig(n_devices=k)
        step = D.make_fl_train_step(cfg, fl, 'spfl', mesh=mesh)
        batch = self._batch(sh.train_batch_specs(cfg, mesh, per_client=True))
        gbar = _tree_of(self.full, _blocks(self.shapes, self.pspecs, mesh,
                                           lambda p: torch.float32))
        q = p = _empty((k,), torch.float32)
        draws = tr.TreeDraws(
            MetaUniforms(k, [math.prod(s) for s in self.shapes.values()]),
            sign_u=_empty((1, k), torch.float32),
            mod_u=_empty((k,), torch.float32))
        k_local = mesh.clients.k_local(k)
        self.memory.update(
            batch=_bytes(batch), gbar=_bytes(gbar),
            grads=k_local * self.memory['params'],
            outputs=self.memory['params'] + _bytes(gbar))

        def run():
            return step(self.params, batch, gbar, q, p, draws)
        return run, {'step': 'fl_train', 'clients': k}

    def _standard(self):
        cfg, shape, mesh = self.cfg, self.shape, self.mesh
        step = D.make_standard_train_step(cfg, FLConfig(n_devices=self.k),
                                          mesh=mesh)
        batch = self._batch(sh.train_batch_specs(cfg, mesh,
                                                 per_client=False))
        self.memory.update(batch=_bytes(batch),
                           outputs=self.memory['params'])

        def run():
            return step(self.params, batch)
        return run, {'step': 'standard_train', 'clients': 0}

    def _gathered_params(self):
        return _tree_of(self.full, {
            p: MA.gather_full(self.mesh, x, self.pspecs[p])
            for p, x in zip(tree.paths(self.params),
                            tree.leaves(self.params))})

    def _prefill(self):
        cfg, shape, mesh = self.cfg, self.shape, self.mesh
        batch = self._batch(sh.prefill_batch_spec(cfg, mesh))
        full_cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   torch.bfloat16, device=META)
        cspecs = sh.cache_specs(cfg, mesh, shape, full_cache)
        cache_out = _blocks(sh.shapes_of(full_cache), cspecs, mesh,
                            lambda p: torch.bfloat16)
        self.memory.update(batch=_bytes(batch),
                           cache=sum(map(_nbytes, cache_out.values())),
                           outputs=sum(map(_nbytes, cache_out.values())))

        def run():
            with torch.no_grad():
                logits, cache = tf.prefill(
                    self._gathered_params(), cfg, batch['tokens'],
                    shape.seq_len, prefix_embeds=batch.get('prefix'))
                return logits, {
                    p: _cache_block(x, cspecs[p], mesh)
                    for p, x in zip(tree.paths(cache), tree.leaves(cache))}
        return run, {'step': 'prefill', 'clients': 0}

    def _decode(self):
        cfg, shape, mesh = self.cfg, self.shape, self.mesh
        full_cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   torch.bfloat16, device=META)
        cspecs = sh.cache_specs(cfg, mesh, shape, full_cache)
        cache = _tree_of(full_cache, _blocks(
            sh.shapes_of(full_cache), cspecs, mesh,
            lambda p: torch.bfloat16))
        token = self._batch(
            {'token': sh.decode_token_spec(cfg, mesh, shape)})['token']
        self.memory.update(batch=_nbytes(token), cache=_bytes(cache),
                           outputs=_bytes(cache))

        def run():
            with torch.no_grad():
                local = _tree_of(cache, {
                    p: _gather_local(x, cspecs[p], mesh, 1)
                    for p, x in zip(tree.paths(cache), tree.leaves(cache))})
                logits, new = tf.decode_step(self._gathered_params(), cfg,
                                             local, token, shape.seq_len - 1)
                return logits, {
                    p: _cache_block(x, cspecs[p], mesh)
                    for p, x in zip(tree.paths(new), tree.leaves(new))}
        return run, {'step': 'decode', 'clients': 0}


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh: ProductionMesh
               ) -> dict:
    """One rank's step traced on the meta device -> its record's step,
    memory, cost and collectives."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    st = StepTrace(cfg, shape, mesh)
    run, rec = st.arguments()
    mem = st.memory
    args = sum(v for key, v in mem.items()
               if key in ('params', 'gbar', 'batch', 'cache'))
    flops = FlopCounterMode(display=False)
    with CommDebugMode() as comm, flops, LiveBytes() as live:
        run()
    counts = {k: 0 for k in KINDS}
    for op, n in comm.get_comm_counts().items():
        kind = collective_kind(f'c10d.{op}' if 'c10d' not in str(op)
                               else str(op))
        if kind is not None:
            counts[kind] += int(n)
    held = args + mem.get('grads', 0)
    rec.update(
        memory={'argument_size_in_bytes': args,
                'output_size_in_bytes': mem['outputs'],
                'params_bytes': mem['params'],
                'gbar_bytes': mem.get('gbar', 0),
                'grads_bytes': mem.get('grads', 0),
                'batch_bytes': mem.get('batch', 0),
                'cache_bytes': mem.get('cache', 0),
                'held_bytes': held,
                'fits_80gb': held <= DEVICE_BYTES,
                'peak_live_bytes': args + live.peak,
                'peak_fits_80gb': args + live.peak <= DEVICE_BYTES,
                'reading': 'arguments from the specs; peak_live_bytes: the '
                           'arguments plus the most bytes of tensors made '
                           'in the trace alive at once (LiveBytes)'},
        cost={'flops': float(flops.get_total_flops())},
        collectives={k: {'count': counts[k], 'bytes': live.bytes[k]}
                     for k in KINDS})
    return rec


def mesh_name(multi_pod: bool) -> str:
    return 'pod2x16x16' if multi_pod else 'pod16x16'


def fake_group(world: int, rank: int = 0) -> None:
    """The fake process group of ``world`` ranks, this process rank
    ``rank``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group('fake', rank=rank, world_size=world,
                            store=FakeStore())


def run_one(arch: Union[str, ModelConfig], shape_name: Union[str,
            ShapeConfig], multi_pod: bool = False,
            out_dir: Optional[str] = ARTIFACT_DIR,
            mesh_shape: Optional[Tuple[Sequence[int], Sequence[str]]] = None,
            rank: int = 0) -> dict:
    """One (arch, shape, mesh) dry run: rank ``rank`` of the production
    mesh (``mesh_shape`` (shape, axes): another mesh, as the tests'
    small ones) in a fake group of its size, which is destroyed after.
    -> the record (written to ``out_dir`` unless it is None)."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape_name) if isinstance(shape_name, str) \
        else shape_name
    ok, why = applicable(cfg, shape)
    if mesh_shape is None:
        mesh_shape = ((MULTI_POD_SHAPE, MULTI_POD_AXES) if multi_pod
                      else (SINGLE_POD_SHAPE, SINGLE_POD_AXES))
        name = mesh_name(multi_pod)
    else:
        name = 'x'.join(map(str, mesh_shape[0]))
    record = {
        'arch': cfg.name, 'shape': shape.name, 'mesh': name,
        'applicable': ok, 'skip_reason': why,
        'params': cfg.param_count(), 'active_params': cfg.active_param_count(),
        'n_layers': cfg.n_layers, 'n_devices': math.prod(mesh_shape[0]),
        'rank': rank, 'fake_group': FAKE_GROUP,
    }
    if ok:
        fake_group(record['n_devices'], rank)
        try:
            mesh = ProductionMesh(*mesh_shape)
            t0 = time.perf_counter()
            record.update(trace_step(cfg, shape, mesh))
            record['compile_s'] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f'{cfg.name}__{shape.name}__{name}.json')
        with open(path, 'w') as f:
            json.dump(record, f, indent=1)
        record['artifact'] = path
    return record


def summary(rec: dict) -> str:
    """One line of a record: per-rank bytes against 80 GB, FLOPs and the
    collectives."""
    if not rec['applicable']:
        return f'skip: {rec["skip_reason"]}'
    m = rec['memory']
    coll = {k: [v['count'], v['bytes']] for k, v in rec['collectives'].items()
            if v['count']}
    return (f'held {m["held_bytes"] / 1e9:.3f} GB (params '
            f'{m["params_bytes"] / 1e9:.3f}, grads {m["grads_bytes"] / 1e9:.3f}'
            f', gbar {m["gbar_bytes"] / 1e9:.3f}, cache '
            f'{m["cache_bytes"] / 1e9:.3f}) of 80 -> '
            f'{"fits" if m["fits_80gb"] else "EXCEEDS"}; peak live '
            f'{m["peak_live_bytes"] / 1e9:.3f} GB; flops '
            f'{rec["cost"]["flops"]:.4e}; collectives [count, bytes] '
            f'{json.dumps(coll)}; trace {rec["compile_s"]:.2f} s')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default=None)
    ap.add_argument('--shape', default=None)
    ap.add_argument('--all', action='store_true')
    ap.add_argument('--multi-pod', action='store_true')
    ap.add_argument('--single-pod', action='store_true')
    ap.add_argument('--out-dir', default=ARTIFACT_DIR)
    ap.add_argument('--resume', action='store_true',
                    help='skip combos whose artifact already exists')
    args = ap.parse_args(argv)

    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or not args.single_pod:
        meshes.append(True)
    if args.all:
        combos = [(a, s) for a in ARCHITECTURES for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error('--arch and --shape (or --all)')
        combos = [(args.arch, args.shape)]

    failures = 0
    for a, s in combos:
        for mp in meshes:
            tag = f'{a} x {s} x {"2x16x16" if mp else "16x16"}'
            if args.resume and os.path.exists(os.path.join(
                    args.out_dir, f'{a}__{s}__{mesh_name(mp)}.json')):
                print(f'[HAVE] {tag}', flush=True)
                continue
            try:
                rec = run_one(a, s, mp, out_dir=args.out_dir)
                print(f'[{"OK" if rec["applicable"] else "SKIP"}]'
                      f'{"  " if rec["applicable"] else ""} {tag}: '
                      f'{summary(rec)}', flush=True)
            except Exception as e:        # noqa: BLE001 (reported, counted)
                failures += 1
                print(f'[FAIL] {tag}: {e}', flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f'{failures} dry-run failures')
    return 0


if __name__ == '__main__':
    main()
