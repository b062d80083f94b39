"""The 'model' axis of a production mesh (``launch.mesh.ProductionMesh``,
``training.model_axis``) on the CPU: one spawn of 4 gloo ranks at
(data=2, model=2) (``python tests/test_torch_model_axis.py --worker``:
every rank runs every case and writes its results), on
smollm-135m-reduced and mamba2-130m-reduced (their 'model' specs split
the embedding, the attention, the MLP and the Mamba projections).

Each case is held to the step without the 'model' axis on the same
rank's clients and the same draws (the parameters whole on the rank;
the packed wire's client axis sharded as ``collective='sharded'``; the
analytic wire's client rows gathered):

* each per-client gradient block equals the same slice of the unsharded
  pass's gradients bit for bit;
* the integers are exact: the knob indices and sign bits of each block
  (analytic wire), each leaf's packed sign and knob words (packed wire),
  ``sign_ok``, ``mod_ok``, the bit channel's flips and CRC verdicts, and
  ``g_min``/``g_max`` (an all-reduce MIN/MAX);
* the new parameters and ḡ are within 9.9e-8 of each leaf's largest
  magnitude (the bound the sharded collective holds for reordered float32
  sums; here they come out bit for bit), and ||g_k||^2 within (2 L + 2)
  eps relative, L the leaves (``model_axis.g2_rtol``: each leaf's block
  sums and its share of the all-reduce over 'model' round once more).

The standard step (``make_standard_train_step(mesh=)``) on the rank's
rows of the global batch takes the mean of the client ranks' mean
losses: its new parameters are within 4 eps of each leaf's largest
magnitude of the mean of the unsharded steps on each client rank's rows
(the float32 sum over the ranks and the update round once each), on
smollm-135m-reduced and on arctic-480b-reduced, whose four experts split
over 'data' (expert parallelism: the reduce-scatter).  On the dense
model that is also the whole batch's step: its update within 1e-4 of
the whole batch step's largest update (each gradient's sum over the
batch rows regrouped as two halves).  A MoE's capacity and load-balance
loss are per batch, so arctic's whole-batch step is another function.
The FL step refuses a tree split over the client axes.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / 'src'
EPS = float(np.finfo(np.float32).eps)
WORLD, MESH = 4, ((2, 2), ('data', 'model'))
K, B, T = 4, 2, 16
ARCHS = ('smollm-135m-reduced', 'mamba2-130m-reduced')
WIRES = ('analytic', 'packed')
PARAM_RTOL = 9.9e-8
STANDARD_RTOL = 4 * EPS
WHOLE_BATCH_RTOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _inputs(cfg, seed: int = 0):
    from repro_torch import tree
    from repro_torch.core import transport as tr
    from repro_torch.models import transformer as tf
    g = torch.Generator().manual_seed(seed)
    params = tf.init_params(cfg, g)
    toks = torch.randint(0, cfg.vocab_size, (K, B, T), generator=g,
                         dtype=torch.int32)
    gbar = tree.map(lambda p: torch.rand(p.shape, generator=g) * 0.01,
                    params)
    q = 0.5 + 0.5 * torch.rand(K, generator=g)
    p = 0.5 + 0.5 * torch.rand(K, generator=g)
    sizes = [x.numel() for x in tree.leaves(params)]
    rand = [torch.rand((K, n), generator=g) for n in sizes]
    host = {c: tr.tree_host_draws(K, len(sizes), 0, c, g)
            for c in ('bitlevel', 'bernoulli')}
    return params, toks, gbar, q, p, rand, host


def _rel(a, b) -> float:
    scale = max(float(b.abs().max()), 1e-30)
    return float((a.double() - b.double()).abs().max()) / scale


class Cases:
    def __init__(self, mesh):
        self.mesh = mesh
        self.out = {}

    def arch(self, name: str) -> None:
        from repro_torch import tree
        from repro_torch.configs.base import FLConfig
        from repro_torch.configs.registry import get_arch
        from repro_torch.core import transport as tr
        from repro_torch.kernels import ops as kops
        from repro_torch.training import distributed as D
        from repro_torch.training import model_axis as MA
        cfg = get_arch(name)
        mesh, cm = self.mesh, self.mesh.clients
        params, toks, gbar, q, p, rand, host = _inputs(cfg)
        layout = MA.Layout(cfg, mesh)
        rows = cm.rows(K)
        blocks = MA.shard_params(params, layout)
        gb_blocks = MA.shard_params(gbar, layout)
        # the per-client gradient blocks
        _, got = MA.client_grads(blocks, cfg, toks[rows], layout)
        _, want = D.client_grads(params, cfg, toks[rows])
        want = tree.leaves(want)
        self.out[f'{name}.grads'] = {
            'sharded': sum(bool(MA._sharded_dims(s)) for s in layout.specs),
            'equal': all(torch.equal(a, layout.block_of(i, b, 1))
                         for i, (a, b) in enumerate(zip(got, want)))}
        stats = MA.model_stats(got, layout)
        ref_stats = tr.tree_client_stats(want)
        bits = FLConfig().quant_bits
        # the integers on the wire: knob indices and signs of each block
        # (analytic), each leaf's sign and knob words (packed)
        lo, hi = stats['g_min'], stats['g_max']
        bd = MA.BlockDraws(rand, layout)
        knobs = words = True
        for i, (a, b) in enumerate(zip(got, want)):
            mine = tr.stochastic_quantize(
                a.reshape(a.shape[0], -1), bits, bd[i][rows], lo[:, None],
                hi[:, None])
            full = tr.stochastic_quantize(
                b.reshape(b.shape[0], -1), bits, rand[i][rows],
                ref_stats['g_min'][:, None], ref_stats['g_max'][:, None])
            kfull = full.qidx.reshape(b.shape)
            sfull = full.sign.reshape(b.shape)
            knobs &= torch.equal(mine.qidx.reshape(a.shape),
                                 layout.block_of(i, kfull, 1))
            knobs &= torch.equal(mine.sign.reshape(a.shape),
                                 layout.block_of(i, sfull, 1))
            whole = MA.gather_full(mesh, a, layout.specs[i], lead=1)
            sw, qw = kops.quantize_pack_flat(
                whole.reshape(a.shape[0], -1).float().contiguous(),
                rand[i][rows], lo, hi, bits)
            rsw, rqw = kops.quantize_pack_flat(
                b.reshape(b.shape[0], -1).float().contiguous(),
                rand[i][rows], ref_stats['g_min'], ref_stats['g_max'], bits)
            words &= torch.equal(sw, rsw) and torch.equal(qw, rqw)
        self.out[f'{name}.wire'] = {'knobs': bool(knobs),
                                    'words': bool(words)}
        for wire in WIRES:
            chan = 'bitlevel' if wire == 'packed' else 'bernoulli'
            coll = 'sharded' if wire == 'packed' else 'gather'
            fl = FLConfig(n_devices=K, wire=wire, channel=chan,
                          collective=coll)
            draws = tr.TreeDraws(rand, **host[chan])
            step = D.make_fl_train_step(cfg, fl, mesh=mesh)
            new_p, new_g, m = step(blocks, {'tokens': toks[rows]}, gb_blocks,
                                   q, p, draws)
            if coll == 'sharded':
                ref = D.make_fl_train_step(cfg, fl, mesh=cm)
                rp, rg, rm = ref(params, {'tokens': toks[rows]}, gbar, q, p,
                                 draws)
            else:
                ref = D.make_fl_train_step(cfg, fl)
                rp, rg, rm = ref(params, {'tokens': toks}, gbar, q, p,
                                 draws)
            ints = ['sign_ok', 'mod_ok', 'g_min', 'g_max']
            tel = m['telemetry']
            rtel = rm['telemetry']
            if chan == 'bitlevel':
                ints_tel = ('sign_flips', 'mod_flips', 'sign_crc_ok',
                            'mod_crc_ok')
            else:
                ints_tel = ()
            self.out[f'{name}.{wire}'] = {
                'ints': {f: bool(torch.equal(m[f], rm[f])) for f in ints}
                | {f: bool(torch.equal(getattr(tel, f), getattr(rtel, f)))
                   for f in ints_tel},
                'params': max(_rel(a, layout.block_of(i, b)) for i, (a, b)
                              in enumerate(zip(tree.leaves(new_p),
                                               tree.leaves(rp)))),
                'gbar': max(_rel(a, layout.block_of(i, b)) for i, (a, b)
                            in enumerate(zip(tree.leaves(new_g),
                                             tree.leaves(rg)))),
                'g2': float(((m['g_norm_sq'] - rm['g_norm_sq'])
                             / rm['g_norm_sq']).abs().max()),
                'g2_bound': MA.g2_rtol(len(layout.paths)),
                'loss': float((m['client_losses']
                               - rm['client_losses']).abs().max())}

    def standard(self, name: str) -> None:
        from repro_torch import tree
        from repro_torch.configs.base import FLConfig
        from repro_torch.configs.registry import get_arch
        from repro_torch.training import distributed as D
        from repro_torch.training import model_axis as MA
        cfg = get_arch(name)
        mesh, cm = self.mesh, self.mesh.clients
        params, toks, _, _, _, _, _ = _inputs(cfg, seed=1)
        flat = toks.reshape(K * B, T)
        n_rows = K * B // cm.size
        mine = slice(cm.rank * n_rows, (cm.rank + 1) * n_rows)
        layout = MA.Layout(cfg, mesh)
        fl = FLConfig(n_devices=K)
        new, met = D.make_standard_train_step(cfg, fl, mesh=mesh)(
            MA.shard_params(params, layout), {'tokens': flat[mine]})
        plain = D.make_standard_train_step(cfg, fl)
        # the mean of the unsharded steps on each client rank's rows
        parts = [plain(params, {'tokens': flat[r * n_rows:(r + 1) * n_rows]})
                 for r in range(cm.size)]
        ref = tree.map(lambda p, *ns: (sum(n.double() for n in ns)
                                       / len(ns)).to(p.dtype),
                       params, *[pp for pp, _ in parts])
        ref_loss = sum(float(m['loss']) for _, m in parts) / cm.size
        whole, wm = plain(params, {'tokens': flat})
        err = err_whole = 0.0
        for i, (a, b, w, p0) in enumerate(zip(
                tree.leaves(new), tree.leaves(ref), tree.leaves(whole),
                tree.leaves(params))):
            b, w = layout.block_of(i, b), layout.block_of(i, w)
            p0 = layout.block_of(i, p0)
            err = max(err, _rel(a, b))
            step_size = max(float((w.double() - p0.double()).abs().max()),
                            1e-30)
            err_whole = max(err_whole, float(
                (a.double() - w.double()).abs().max()) / step_size)
        self.out[f'{name}.standard'] = {
            'params': err, 'update_vs_whole': err_whole,
            'loss': abs(float(met['loss']) - ref_loss),
            'loss_vs_whole': abs(float(met['loss']) - float(wm['loss'])),
            'expert_parallel': any(layout.on_clients)}
        try:
            D.make_fl_train_step(cfg, fl, mesh=mesh)
            self.out[f'{name}.refuses'] = not any(layout.on_clients)
        except ValueError:
            self.out[f'{name}.refuses'] = any(layout.on_clients)


def worker_main(rank: int, port: int, out_dir: Path) -> None:
    import torch.distributed as tdist
    torch.set_num_threads(1)
    tdist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                             rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import ProductionMesh
        mesh = ProductionMesh(*MESH)
        cases = Cases(mesh)
        for name in ARCHS:
            cases.arch(name)
        for name in ('smollm-135m-reduced', 'arctic-480b-reduced'):
            cases.standard(name)
        cases.out['coords'] = mesh.coords
        (out_dir / f'rank{rank}.json').write_text(json.dumps(cases.out))
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# pytest's side
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The 4 ranks' results (one spawn for the file)."""
    out = tmp_path_factory.mktemp('model_axis')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(SRC)] + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, '--worker', str(r), str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = []
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=300)
            if proc.returncode:
                errs.append(f'rank {r}: {err[-3000:]}')
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errs, '\n'.join(errs)
    return [json.loads((out / f'rank{r}.json').read_text())
            for r in range(WORLD)]


def test_ranks_lie_row_major(ranks):
    assert [tuple(r['coords'].values()) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize('arch', ARCHS)
def test_gradient_blocks_are_the_unsharded_slices(ranks, arch):
    for r in ranks:
        res = r[f'{arch}.grads']
        assert res['sharded'] > 0 and res['equal']


@pytest.mark.parametrize('arch', ARCHS)
def test_wire_integers_are_exact(ranks, arch):
    for r in ranks:
        assert r[f'{arch}.wire'] == {'knobs': True, 'words': True}


@pytest.mark.parametrize('wire', WIRES)
@pytest.mark.parametrize('arch', ARCHS)
def test_fl_step_equals_the_unsharded_step(ranks, arch, wire):
    for r in ranks:
        res = r[f'{arch}.{wire}']
        assert all(res['ints'].values()), res['ints']
        assert res['params'] <= PARAM_RTOL, res
        assert res['gbar'] <= PARAM_RTOL, res
        assert res['g2'] <= res['g2_bound'], res
        assert res['loss'] == 0.0, res


@pytest.mark.parametrize('arch', ['smollm-135m-reduced',
                                  'arctic-480b-reduced'])
def test_standard_step(ranks, arch):
    for r in ranks:
        res = r[f'{arch}.standard']
        assert res['expert_parallel'] == arch.startswith('arctic')
        assert res['params'] <= STANDARD_RTOL, res
        assert res['loss'] == 0.0, res
        if not res['expert_parallel']:
            assert res['update_vs_whole'] <= WHOLE_BATCH_RTOL, res
        assert r[f'{arch}.refuses']


if __name__ == '__main__':
    if sys.argv[1] == '--worker':
        worker_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
