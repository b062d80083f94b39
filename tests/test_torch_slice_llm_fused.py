"""The rest of the LLM-scale slice on the CPU, on the reduced smollm: the
fused round (``training.distributed.make_fused_fl_round``) against the
port's host step given the same (q, p) and draws, its exact v_k and
||ḡ||^2 against a float32 NumPy reduction, 'scan' against 'eager' and
fused error_free against the launcher's host loop (bit for bit), the
sharded step and launcher at S = 2 gloo ranks against the gathered ones
(``python tests/test_torch_slice_llm_fused.py --worker``), population
cohorts on the LLM path against ``repro.population`` on the reference's
key chain, and the launcher's promotions against the reference's
messages.

Contract of the sharded step: the gradients of a rank's clients are the
gathered step's bits (vmap over fewer clients), so the losses, the
per-client stats and every integer equal the gathered step's, and ĝ is
within S times the FMA-wobble bound (``test_torch_parity.ulp_atol``) and
the same bits on both ranks.
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
REPO = HERE.parent
ARCH = 'smollm-135m-reduced'
EPS = float(np.finfo(np.float32).eps)
K, B, T, LR = 4, 2, 16, 0.05
RUN = dict(arch=ARCH, clients=3, batch=2, seq=16, transport_kind='spfl',
           allocator='uniform', lr=LR, bandwidth_hz=10e9, tx_power_dbm=-4.0,
           wire='packed', allocation_backend='jax', device='cpu')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """Small tensors: one intra-op thread (the suite runs in several
    workers, and more threads only contend), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=0, k=K):
    from repro_torch import tree
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import synth_tokens
    from repro_torch.models import transformer as tf
    cfg = get_arch(ARCH)
    params = tf.init_params(cfg, torch.Generator().manual_seed(seed))
    toks = torch.as_tensor(synth_tokens(k * B, T + 1, cfg.vocab_size, seed)
                           .reshape(k, B, T + 1))[..., :T]
    gen = torch.Generator().manual_seed(seed + 5)
    gbar = tree.map(lambda p: torch.rand(p.shape, generator=gen) * 1e-3,
                    params)
    return cfg, params, toks, gbar


def _draws(params, k, channel, kind='spfl', seed=9):
    from repro_torch import tree
    from repro_torch.core import transport as tr
    sizes = [int(p.numel()) for p in tree.leaves(params)]
    d = tr.make_tree_draws(k, sizes, 0, channel, 'cpu',
                           torch.Generator().manual_seed(seed),
                           torch.Generator().manual_seed(seed + 1), kind=kind)
    return d._replace(rand=list(d.rand))


def ulp_atol(weight, gmax, gbar_max) -> float:
    scale = float(np.sum(np.asarray(weight, np.float32)
                         * np.maximum(np.asarray(gmax, np.float32),
                                      gbar_max)))
    return 4 * EPS * max(scale, 1.0)


@pytest.mark.parametrize('channel', ['bernoulli', 'bitlevel'])
def test_fused_round_equals_the_host_step_given_its_q_p(channel):
    """One fused round (barrier solve on a non-zero ḡ) and the host step
    fed the round's own (q, p) and the same draws: the same parameters,
    ḡ, loss and telemetry, bit for bit; the fused solve is not the
    uniform point."""
    from repro_torch import tree
    from repro_torch.configs.base import FLConfig
    from repro_torch.training import distributed as TD
    cfg, params, toks, gbar = _setup()
    fl = FLConfig(n_devices=K, wire='packed', channel=channel,
                  allocation_backend='jax', allocator='barrier',
                  learning_rate=LR, bandwidth_hz=10e9, tx_power_dbm=10.0,
                  allocation_max_iters=1)
    draws = _draws(params, K, channel)
    gains = torch.tensor([3e-9, 1e-8, 5e-9, 2e-8], dtype=torch.float64)
    round_fn = TD.make_fused_fl_round(cfg, fl)
    p2, opt2, gb2, rec, loss = round_fn(
        params, (), gbar, {'tokens': toks}, gains, draws,
        torch.tensor(7))
    assert int(rec.round_idx) == 7 and int(rec.alloc_exit_reason) != 3
    q, p = rec.q, rec.p
    assert not torch.equal(q, torch.ones(K))
    step = TD.make_fl_train_step(cfg, fl)
    h_params, h_gbar, m = step(params, {'tokens': toks}, gbar, q, p, draws)
    for a, b in zip(tree.leaves(p2) + tree.leaves(gb2),
                    tree.leaves(h_params) + tree.leaves(h_gbar)):
        assert torch.equal(a, b)
    assert torch.equal(loss, m['loss'])
    tel = m['telemetry']
    for f in ('sign_ok', 'mod_ok', 'payload_bits', 'sign_flips'):
        a, b = getattr(rec, f), getattr(tel, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def test_round_zero_solves_at_the_uniform_point():
    """ḡ = 0 (round 0): the solver's gate takes the 'uniform' method, on
    the device (the reference's ``lax.cond``), on the round's float32
    problem."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import allocation_jax as AJ
    from repro_torch.core import transport as tr
    from repro_torch.kernels import ops
    from repro_torch.training import distributed as TD
    cfg, params, toks, _ = _setup(1)
    fl = FLConfig(n_devices=K, wire='packed', allocation_backend='jax',
                  allocator='barrier', learning_rate=LR, bandwidth_hz=10e9)
    gains = torch.full((K,), 1e-8, dtype=torch.float64)
    rec = TD.make_fused_fl_round(cfg, fl)(
        params, (), TD.init_gbar(params), {'tokens': toks}, gains,
        _draws(params, K, 'bernoulli'), torch.tensor(0))[3]
    _, grads = TD.client_grads(params, cfg, toks)
    stats = tr.tree_client_stats(grads)
    zero = torch.zeros(K)
    prob = AJ.problem_from_stats(
        stats['g2'], zero, zero,
        tr.delta_sq_tree(stats, fl.quant_bits).to(torch.float32), gains,
        torch.full((K,), fl.tx_power_w), stats['dim'], fl,
        dtype=torch.float32)
    uni = ops.alloc_solve(prob, 'uniform')
    assert torch.equal(rec.q, uni.q) and torch.equal(rec.p, uni.p)
    assert torch.equal(rec.alloc_objective, uni.objective)


def test_exact_v_and_gbar_norm_against_numpy_float32():
    from repro_torch import tree
    from repro_torch.training import distributed as TD
    cfg, params, toks, gbar = _setup(2)
    _, grads = TD.client_grads(params, cfg, toks)
    v = TD.exact_v(grads, gbar).numpy()
    gb2 = float(TD.gbar_norm_sq(gbar))
    g = [x.float().numpy().reshape(K, -1) for x in tree.leaves(grads)]
    b = [x.float().numpy().reshape(1, -1) for x in tree.leaves(gbar)]
    want_v = sum(np.sum(np.abs(gi) * bi, axis=1, dtype=np.float32)
                 for gi, bi in zip(g, b))
    want_gb2 = sum(np.sum(np.square(bi), dtype=np.float32) for bi in b)
    assert v.dtype == np.float32
    np.testing.assert_allclose(v, want_v, rtol=2e-6)
    np.testing.assert_allclose(gb2, want_gb2, rtol=2e-6)


def _rows(path):
    from repro_torch.obs import read_jsonl
    _, rows = read_jsonl(path)
    return [{k: v for k, v in r.items() if k != 'step_s'} for r in rows]


def test_scan_equals_eager_and_fused_error_free_equals_host_loop(tmp_path):
    """Three rounds in segments of 2 and 1 ('scan': one graph a segment
    length on the card; 'eager': one round's graph; the barrier solve is
    held in the single-round tests above): the same losses, (q, p) and
    telemetry rows, bit for bit; error_free fused = the host loop (under
    deterministic algorithms) bit for bit."""
    from repro_torch.launch import train as LT
    base = dict(RUN, steps=3, scan_segment_rounds=2)
    runs = {}
    for mode in ('scan', 'eager'):
        path = str(tmp_path / f'{mode}.jsonl')
        runs[mode] = (LT.run(**base, round_fusion=mode, telemetry_path=path),
                      _rows(path))
    (hs, rs), (he, re_) = runs['scan'], runs['eager']
    for key in ('loss', 'q', 'p'):
        assert hs[key] == he[key], key
    assert rs == re_ and len(rs) == 3
    assert any(q != 1.0 for q in hs['q'][1:])
    ef = dict(base, transport_kind='error_free')
    host = LT.run(**ef, deterministic=True)
    fused = LT.run(**ef, round_fusion='scan')
    assert host['loss'] == fused['loss']
    assert host['q'] == fused['q'] == [1.0] * 3


def test_population_cohorts_follow_the_reference_chain(tmp_path):
    """Population mode on the LLM path (promoted to 'scan'): each round's
    cohort ids are ``repro.population.sample_cohort`` of the reference's
    chain (``split`` of ``fold_in(PRNGKey(seed), 100)`` once a round)."""
    import jax
    from repro import population as RP
    from repro.configs.base import FLConfig as RFL
    from repro_torch.launch import train as LT
    path = str(tmp_path / 'pop.jsonl')
    kw = dict(population_n=10 ** 6, cohort_size=3,
              cohort_sampler='availability')
    hist = LT.run(**dict(RUN, steps=3, seed=4), telemetry_path=path, **kw)
    assert len(hist['loss']) == 3
    from repro_torch.obs import read_jsonl
    _, rows = read_jsonl(path)
    fl = RFL(n_devices=3, seed=4, **kw)
    key = jax.random.fold_in(jax.random.PRNGKey(4), 100)
    pkey = RP.population_key(4)
    for row in rows:
        key, kr = jax.random.split(key)
        want = np.asarray(RP.sample_cohort(kr, pkey, fl).ids)
        assert row['cohort_ids'] == want.astype(np.int64).tolist()


def test_promotions_print_the_reference_messages(capsys):
    """The launcher's promotions, with the reference's messages (its
    ``repro/launch/train.py`` cannot be imported under this jax)."""
    from repro_torch.launch import train as LT
    assert LT.promote(5, 'none', 'numpy') == ('scan', 'jax')
    out = capsys.readouterr().out.splitlines()
    want = ["population mode: promoting round_fusion='none' -> 'scan' "
            '(cohorts are sampled in-trace)',
            "round_fusion: promoting allocation_backend='numpy' -> 'jax' "
            '(in-trace eq. (28) solve)']
    assert out == want
    ref = (REPO / 'src' / 'repro' / 'launch' / 'train.py').read_text()
    for frag in ("population mode: promoting round_fusion='none' -> 'scan' ",
                 '(cohorts are sampled in-trace)',
                 "round_fusion: promoting allocation_backend='numpy' -> ",
                 "'jax' (in-trace eq. (28) solve)"):
        assert frag in ref, frag
    assert LT.promote(0, 'eager', 'jax') == ('eager', 'jax')
    assert LT.promote(0, 'none', 'numpy') == ('none', 'numpy')


def test_fused_segment_refusals():
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.training import distributed as TD
    cfg = get_arch(ARCH)
    with pytest.raises(ValueError, match='eager|scan'):
        TD.make_fused_fl_scan(cfg, FLConfig(allocation_backend='jax'), None,
                              None)
    with pytest.raises(ValueError, match='spfl|error_free'):
        TD.make_fused_fl_round(cfg, FLConfig(allocation_backend='jax'),
                               transport_kind='dds')


# ---------------------------------------------------------------------------
# the sharded step and launcher at S = 2 gloo ranks
# ---------------------------------------------------------------------------

def worker_main(rank: int, world: int, port: int, out: Path) -> None:
    import torch.distributed as tdist
    torch.set_num_threads(1)
    tdist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                             rank=rank, world_size=world)
    try:
        out.joinpath(f'rank{rank}.json').write_text(json.dumps(_sharded()))
    finally:
        tdist.destroy_process_group()


def _same_bits(mesh, t):
    mine = t.detach().reshape(1, -1).contiguous().view(torch.int32)
    every = mesh.all_gather(mine)
    assert all(torch.equal(every[r], mine[0]) for r in range(mesh.size))


def _sharded() -> dict:
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs.base import FLConfig
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import distributed as TD
    mesh = make_host_mesh()
    S = mesh.size
    cfg, params, toks, gbar = _setup(3)
    out = {}
    for channel in ('bitlevel',):
        fl = FLConfig(n_devices=K, wire='packed', channel=channel,
                      learning_rate=LR)
        q = torch.tensor([0.6, 0.8, 0.9, 0.7])
        p = torch.tensor([0.7, 0.5, 0.95, 0.8])
        draws = _draws(params, K, channel)
        want = TD.make_fl_train_step(cfg, fl)(params, {'tokens': toks},
                                              gbar, q, p, draws)
        sh = dataclasses.replace(fl, collective='sharded')
        got = TD.make_fl_train_step(cfg, sh, mesh=mesh)(
            params, {'tokens': toks[mesh.rows(K)]}, gbar, q, p, draws)
        (wp, wg, wm), (gp, gg, gm) = want, got
        for f in ('loss', 'client_losses', 'g_norm_sq', 'g_min', 'g_max',
                  'sign_ok', 'mod_ok', 'payload_bits'):
            assert torch.equal(gm[f], wm[f]), f
        for f in ('sign_flips', 'mod_flips'):
            a, b = getattr(gm['telemetry'], f), getattr(wm['telemetry'], f)
            assert (a is None and b is None) or torch.equal(a, b), f
        gmax = float(max(x.abs().max() for x in tree.leaves(gbar)))
        # ḡ = |ĝ|, float32
        atol = S * ulp_atol(1.0 / q.numpy(), wm['g_max'].numpy(), gmax)
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(tree.leaves(gg), tree.leaves(wg)))
        assert err <= atol, (channel, err, atol)
        for leaf in tree.leaves(gg):
            _same_bits(mesh, leaf)
        out[f'step_{channel}'] = {'max_err': err, 'bound': atol}
    # the launcher: the host loop and fused rounds, sharded vs gathered
    for mode in ('none', 'scan'):
        kw = dict(RUN, clients=K, steps=2, round_fusion=mode)
        want = LT.run(**kw)
        got = LT.run(**kw, collective='sharded')
        np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-6)
        assert got['q'] == want['q'] and got['p'] == want['p']
        out[f'launcher_{mode}'] = {'loss': got['loss']}
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_sharded_llm_step_at_two_ranks_equals_the_gathered_step(tmp_path):
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join([str(SRC), str(HERE)])
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, '--worker', str(r), '2', str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    errs = []
    for r, proc in enumerate(procs):
        _, err = proc.communicate(timeout=300)
        if proc.returncode:
            errs.append(f'rank {r}: {err[-3000:]}')
    assert not errs, '\n'.join(errs)
    res = [json.loads((tmp_path / f'rank{r}.json').read_text())
           for r in range(2)]
    assert res[0]['launcher_scan'] == res[1]['launcher_scan']
    for r in res:
        assert r['step_bitlevel']['max_err'] <= r['step_bitlevel']['bound']


if __name__ == '__main__':
    sys.path[:0] = [str(SRC), str(HERE)]
    if sys.argv[1] != '--worker':
        raise SystemExit(f'unknown mode {sys.argv[1]}')
    worker_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                Path(sys.argv[5]))
