"""The sharded collective (``collective='sharded'``) on the CPU: the ops
(``spfl_aggregate_packed_sharded``, ``corrupt_fold_words(mesh=)``,
``fold_words(mesh=)``), the flat and the tree transports at S in
{1, 2, 3, 4} gloo ranks, each world size spawned once (``python
tests/test_torch_sharded.py --worker``: every rank runs the whole grid of
cases), held to the port's gathered call on the same global inputs, and
at S = 4 to the reference's own sharded functions, run in a subprocess
on a forced 4-device CPU mesh (``--reference``, beside the smaller world
sizes): ``spfl_aggregate_packed_sharded``, ``corrupt_fold_words(mesh=)``
and ``spfl_aggregate_tree(collective='sharded')`` on the Bernoulli
channel (the reference's bit-channel tree pass runs its interpret-mode
kernel for a minute; its sharded corruption is the second call's).

The contract, per case:

* the integers (decoded words, flips, folds, votes, ``sign_ok`` /
  ``mod_ok``, counts) equal the gathered call's bit for bit;
* the f32 sums are within S times the FMA-wobble bound of the gathered
  call (``test_torch_parity.ulp_atol``: 4 eps sum_k w_k max(gmax_k,
  max ḡ)), bit for bit at S = 1; against the reference's sharded call
  at S = 4 within (2 S + 1) times that bound (both sharded sums
  reassociate, and the two gathered kernels already differ by the
  bound);
* every rank's ĝ has the same bits (its words gathered and compared).
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
WORLDS = (1, 2, 3, 4)
BITS = 3
# (K, l) of the flat cases, the tree's leaves (K, ...) and the reference's
FLAT_K, FLAT_L = 7, 300
TREE_K = 5
TREE_SHAPES = {'a': (40,), 'b': (3, 20), 'c': (33,)}
REF_K, REF_N, REF_W = 6, 100, 37
REF_TREE = {'a': (40,), 'b': (3, 20)}

CASES = ('ops_aggregate', 'ops_aggregate_ragged_per_client_gbar',
         'ops_vote_capacity', 'ops_corrupt_fold', 'ops_fold_words',
         'flat_spfl_bitlevel', 'flat_spfl_retx_bitlevel',
         'flat_spfl_bernoulli', 'flat_error_free',
         'flat_screen_signflip_dropout', 'flat_per_client_gbar',
         'tree_spfl_bitlevel', 'tree_spfl_retx_bitlevel',
         'tree_spfl_bernoulli_scaled_screen', 'tree_error_free',
         'tree_per_client_gbar')
REFERENCE_CASES = ('reference_aggregate', 'reference_corrupt_fold',
                   'reference_tree')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """Small tensors: one intra-op thread (the suite runs in several
    workers, and more threads only contend), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ulp_atol(weight, gmax, gbar) -> float:
    """4 eps x sum_k w_k max(gmax_k, max |ḡ|) (the reference's bound,
    ``test_torch_parity.ulp_atol``)."""
    scale = float(np.sum(np.abs(np.asarray(weight, np.float32))
                         * np.maximum(np.asarray(gmax, np.float32),
                                      float(np.max(np.abs(np.asarray(gbar)))
                                            if np.size(gbar) else 0.0))))
    return 4 * EPS * max(scale, 1.0)


# ---------------------------------------------------------------------------
# the rank side (python tests/test_torch_sharded.py --worker ...)
# ---------------------------------------------------------------------------

def _words(gen, shape):
    from repro_torch.wire import format as fmt
    return fmt.to_words(torch.randint(0, 2 ** 32, shape, generator=gen))


def _same_bits(mesh, t: torch.Tensor) -> None:
    """Every rank holds the same bits of ``t``."""
    mine = t.detach().reshape(1, -1).contiguous().view(torch.int32)
    every = mesh.all_gather(mine)
    for r in range(mesh.size):
        assert torch.equal(every[r], mine[0]), f'rank {r} differs'


class Grid:
    """One rank's run of the cases; ``results[case]`` holds the largest
    f32 difference and its bound."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.S = mesh.size
        self.results = {}

    def f32(self, case, got, want, atol):
        err = float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
        bound = 0.0 if self.S == 1 else self.S * atol
        assert err <= bound, f'{case}: f32 error {err} > bound {bound}'
        prev = self.results.get(case, {'max_err': 0.0, 'bound': bound})
        self.results[case] = {'max_err': max(prev['max_err'], err),
                              'bound': max(prev['bound'], bound)}

    def exact(self, case, got, want):
        if want is None:
            assert got is None, f'{case}: expected None'
            return
        assert got is not None and torch.equal(got, want), \
            f'{case}: integers differ'
        self.results.setdefault(case, {'max_err': 0.0, 'bound': 0.0})

    def telemetry(self, case, got, want):
        for f in ('sign_ok', 'mod_ok', 'accepted', 'sign_flips', 'mod_flips',
                  'sign_crc_ok', 'mod_crc_ok', 'retx_attempts', 'sign_votes',
                  'active', 'suspect', 'payload_bits', 'retransmissions'):
            self.exact(f'{case}.{f}', getattr(got, f), getattr(want, f))
        if want.suspicion is not None:
            self.f32(case, got.suspicion, want.suspicion, 0.0)

    def run(self):
        for case in CASES:
            getattr(self, case)(case)
        return self.results

    # -- ops --------------------------------------------------------------
    def _agg_inputs(self, k, n, per_client, seed):
        gen = torch.Generator().manual_seed(seed)
        groups = -(-n // 32)
        sp = _words(gen, (k, groups))
        qp = _words(gen, (k, groups * BITS))
        gbar = torch.rand((k, n) if per_client else (n,), generator=gen)
        gmin = torch.rand((k,), generator=gen) * 0.1
        gmax = gmin + torch.rand((k,), generator=gen)
        mod_ok = torch.rand((k,), generator=gen) < 0.7
        w = torch.rand((k,), generator=gen) * 2.0
        sign_ok = torch.rand((k,), generator=gen) < 0.8
        return sp, qp, gbar, gmin, gmax, mod_ok, w, sign_ok

    def _agg(self, case, k, n, per_client, seed):
        from repro_torch.kernels import ops
        m = self.mesh
        sp, qp, gbar, gmin, gmax, mod_ok, w, sign_ok = self._agg_inputs(
            k, n, per_client, seed)
        want, votes = ops.spfl_aggregate_packed(sp, qp, gbar, gmin, gmax,
                                                mod_ok, w, sign_ok, n, BITS)
        blk = [m.block(x, k) for x in (sp, qp, gmin, gmax, mod_ok, w,
                                       sign_ok)]
        gb = m.block(gbar, k) if per_client else gbar
        got, got_votes = ops.spfl_aggregate_packed_sharded(
            blk[0], blk[1], gb, *blk[2:], n, BITS, mesh=m)
        self.f32(case, got, want, ulp_atol(w, gmax, gbar))
        self.exact(case, got_votes, votes)
        _same_bits(m, got)

    def ops_aggregate(self, case):
        self._agg(case, 6, 100, False, 1)

    def ops_aggregate_ragged_per_client_gbar(self, case):
        self._agg(case, 5, 77, True, 2)

    def ops_vote_capacity(self, case):
        """K = 40: the gathered kernel has no votes (one 32-client word);
        sharded, a rank's block of K_local <= 32 rows has its own word, so
        the votes are the integer sum over the blocks."""
        from repro_torch.kernels import ops
        m, k, n = self.mesh, 40, 70
        sp, qp, gbar, gmin, gmax, mod_ok, w, sign_ok = self._agg_inputs(
            k, n, False, 3)
        want, none = ops.spfl_aggregate_packed(sp, qp, gbar, gmin, gmax,
                                               mod_ok, w, sign_ok, n, BITS)
        assert none is None
        blk = [m.block(x, k) for x in (sp, qp, gmin, gmax, mod_ok, w,
                                       sign_ok)]
        got, votes = ops.spfl_aggregate_packed_sharded(
            blk[0], blk[1], gbar, *blk[2:], n, BITS, mesh=m)
        self.f32(case, got, want, ulp_atol(w, gmax, gbar))
        if m.k_local(k) > ops.MAX_VOTE_CLIENTS:
            self.exact(case, votes, None)
            return
        parts = []
        for r in range(m.size):
            rows = slice(r * m.k_local(k), min((r + 1) * m.k_local(k), k))
            parts.append(ops.spfl_aggregate_packed(
                sp[rows], qp[rows], gbar, gmin[rows], gmax[rows],
                mod_ok[rows], w[rows], sign_ok[rows], n, BITS)[1])
        self.exact(case, votes, sum(parts))

    def ops_corrupt_fold(self, case):
        from repro_torch.kernels import ops
        m = self.mesh
        gen = torch.Generator().manual_seed(4)
        for k in (5, 8):
            words = _words(gen, (k, 37))
            ber = torch.rand((k,), generator=gen) * 0.05
            seeds = (12345, 678910 + k)
            want = ops.corrupt_fold_words(seeds, words, ber)
            got = ops.corrupt_fold_words(seeds, m.block(words, k),
                                         m.block(ber, k), mesh=m)
            for g, w_ in zip(got, want):
                self.exact(case, m.gather_rows(g, k), w_)
        try:
            ops.corrupt_fold_words(seeds, m.block(words, k), 0.1, word0=3,
                                   mesh=m)
        except ValueError as e:
            assert 'mutually exclusive' in str(e)
        else:
            raise AssertionError('word0 with mesh did not raise')

    def ops_fold_words(self, case):
        from repro_torch.kernels import ops
        m, k = self.mesh, 7
        words = _words(torch.Generator().manual_seed(5), (k, 45))
        got = ops.fold_words(m.block(words, k), mesh=m)
        self.exact(case, m.gather_rows(got, k), ops.fold_words(words))

    # -- flat transports --------------------------------------------------
    def _flat(self, case, seed, k=FLAT_K, l=FLAT_L, n_retx=0,
              channel='bitlevel', per_client=False, **kw):
        from repro_torch.core import transport as tr
        m = self.mesh
        gen = torch.Generator().manual_seed(seed)
        grads = torch.randn((k, l), generator=gen) * 0.1
        gbar = torch.rand((k, l) if per_client else (l,), generator=gen) * .1
        q = 0.35 + 0.6 * torch.rand((k,), generator=gen)
        p = 0.35 + 0.6 * torch.rand((k,), generator=gen)
        host = torch.Generator().manual_seed(seed + 1)
        draws = tr.make_draws(k, l, n_retx, channel, torch.device('cpu'),
                              gen, host)
        if 'active' in kw:
            kw['active'] = torch.rand((k,), generator=gen) > 0.2
        if 'byz_mask' in kw:
            kw['byz_mask'] = torch.arange(k) % 4 == 1
        common = dict(n_retx=n_retx, wire='packed', round_idx=3,
                      channel=channel, **kw)
        want, tw = tr.spfl_aggregate(grads, gbar, q, p, BITS, 32, draws,
                                     **common)
        rows = m.rows(k)
        got, tg = tr.spfl_aggregate(
            grads[rows], gbar[rows] if per_client else gbar, q, p, BITS, 32,
            draws, collective='sharded', mesh=m, **common)
        q_eff = 1.0 - (1.0 - q) ** (n_retx + 1)
        self.f32(case, got, want, ulp_atol(1.0 / q_eff,
                                           grads.abs().amax(1), gbar))
        self.telemetry(case, tg, tw)
        _same_bits(m, got)

    def flat_spfl_bitlevel(self, case):
        self._flat(case, 10)

    def flat_spfl_retx_bitlevel(self, case):
        self._flat(case, 11, n_retx=1)

    def flat_spfl_bernoulli(self, case):
        self._flat(case, 12, channel='bernoulli')

    def flat_screen_signflip_dropout(self, case):
        self._flat(case, 13, k=8, attack='signflip', byz_mask=True,
                   screen=True, active=True, min_participation=0.4)

    def flat_per_client_gbar(self, case):
        self._flat(case, 14, k=5, per_client=True)

    def flat_error_free(self, case):
        from repro_torch.configs.base import FLConfig
        from repro_torch.core import transport as tr
        m, k, l = self.mesh, 6, 250
        gen = torch.Generator().manual_seed(15)
        grads = torch.randn((k, l), generator=gen)
        draws = tr.make_draws(k, l, 0, 'bernoulli', torch.device('cpu'), gen,
                              torch.Generator().manual_seed(0),
                              kind='error_free')
        fl = FLConfig(n_devices=k, wire='packed')
        want, tw = tr.error_free_aggregate(grads, fl, draws, round_idx=2)
        got, tg = tr.error_free_aggregate(grads[m.rows(k)], fl, draws,
                                          round_idx=2, collective='sharded',
                                          mesh=m, k=k)
        self.f32(case, got, want,
                 ulp_atol(np.ones(k), grads.abs().amax(1), np.zeros(1)) / k)
        self.telemetry(case, tg, tw)
        _same_bits(m, got)

    # -- tree transports --------------------------------------------------
    def _tree(self, case, seed, k=TREE_K, n_retx=0, channel='bitlevel',
              per_client=False, kind='spfl', **kw):
        from repro_torch import tree
        from repro_torch.configs.base import FLConfig
        from repro_torch.core import transport as tr
        m = self.mesh
        gen = torch.Generator().manual_seed(seed)
        grads = {name: torch.randn((k,) + s, generator=gen) * 0.1
                 for name, s in TREE_SHAPES.items()}
        gbar = {name: torch.rand(((k,) if per_client else ()) + s,
                                 generator=gen) * 0.1
                for name, s in TREE_SHAPES.items()}
        q = 0.4 + 0.55 * torch.rand((k,), generator=gen)
        p = 0.4 + 0.55 * torch.rand((k,), generator=gen)
        sizes = [int(np.prod(s)) for _, s in sorted(TREE_SHAPES.items())]
        host = torch.Generator().manual_seed(seed + 1)
        draws = tr.make_tree_draws(k, sizes, n_retx, channel, 'cpu', gen,
                                   host, kind=kind)
        draws = draws._replace(rand=[draws.rand[i] for i in range(len(sizes))])
        fl = FLConfig(n_devices=k, wire='packed', channel=channel)
        if 'byz_mask' in kw:
            kw['byz_mask'] = torch.arange(k) % 3 == 0
        rows = m.rows(k)
        mine = {n_: g[rows] for n_, g in grads.items()}
        if kind == 'error_free':
            want, sw, tw = tr.error_free_aggregate_tree(grads, fl, draws)
            got, sg, tg = tr.error_free_aggregate_tree(
                mine, fl, draws, collective='sharded', mesh=m, k=k)
            weight = np.ones(k) / k
        else:
            gmine = ({n_: g[rows] for n_, g in gbar.items()} if per_client
                     else gbar)
            want, sw, tw = tr.spfl_aggregate_tree(grads, gbar, q, p, fl,
                                                  draws, n_retx=n_retx, **kw)
            got, sg, tg = tr.spfl_aggregate_tree(
                mine, gmine, q, p, fl, draws, n_retx=n_retx,
                collective='sharded', mesh=m, **kw)
            weight = 1.0 / (1.0 - (1.0 - q) ** (n_retx + 1))
        for f in ('g2', 'g_min', 'g_max'):
            self.exact(f'{case}.{f}', sg[f], sw[f])
        gb_all = torch.cat([x.reshape(-1) for x in tree.leaves(gbar)])
        scale = sw['g_max'] * (kw.get('attack_scale', 1.0)
                               if 'byz_mask' in kw else 1.0)
        atol = ulp_atol(weight, scale, gb_all)
        for a, b in zip(tree.leaves(got), tree.leaves(want)):
            self.f32(case, a, b, atol)
            _same_bits(m, a)
        self.telemetry(case, tg, tw)

    def tree_spfl_bitlevel(self, case):
        self._tree(case, 20)

    def tree_spfl_retx_bitlevel(self, case):
        self._tree(case, 21, n_retx=1)

    def tree_spfl_bernoulli_scaled_screen(self, case):
        self._tree(case, 22, k=7, channel='bernoulli', attack='scaled',
                   byz_mask=True, attack_scale=10.0, screen=True,
                   min_participation=0.3)

    def tree_error_free(self, case):
        self._tree(case, 23, kind='error_free')

    def tree_per_client_gbar(self, case):
        self._tree(case, 24, k=6, per_client=True)

    # -- the reference's own sharded functions, at S = 4 -----------------
    def reference(self, ref_dir: Path):
        from repro_torch import tree
        from repro_torch.configs.base import FLConfig
        from repro_torch.core import transport as tr
        from repro_torch.core.transport import TreeDraws
        from repro_torch.kernels import ops
        from repro_torch.wire import format as fmt
        m, S = self.mesh, self.mesh.size
        inp = np.load(ref_dir / 'inputs.npz')
        out = np.load(ref_dir / 'reference.npz')

        def t(x, dtype=None):
            x = torch.as_tensor(np.asarray(x))
            return x if dtype is None else x.to(dtype)

        def words(x):
            return fmt.to_words(t(np.asarray(x, np.int64)))

        k, n = REF_K, REF_N
        args = [words(inp['sp']), words(inp['qp']), t(inp['gbar']),
                t(inp['gmin']), t(inp['gmax']), t(inp['mod_ok']),
                t(inp['w']), t(inp['sign_ok'])]
        blk = [m.block(x, k) if i != 2 else x for i, x in enumerate(args)]
        acc, votes = ops.spfl_aggregate_packed_sharded(*blk, n, BITS, mesh=m)
        err = float((acc.double() - t(out['acc']).double()).abs().max())
        bound = (2 * S + 1) * ulp_atol(inp['w'], inp['gmax'], inp['gbar'])
        assert err <= bound, f'reference_aggregate: {err} > {bound}'
        assert torch.equal(votes, t(out['votes']).to(torch.int32))
        self.results['reference_aggregate'] = {'max_err': err, 'bound': bound}

        seeds = tuple(int(x) for x in out['cf_seeds'])
        rx, fold, flips = ops.corrupt_fold_words(
            seeds, m.block(words(inp['cf_words']), k),
            m.block(t(inp['cf_ber']), k), mesh=m)
        assert torch.equal(m.gather_rows(rx, k), words(out['cf_rx']))
        assert torch.equal(m.gather_rows(fold, k), words(out['cf_fold']))
        assert torch.equal(m.gather_rows(flips, k),
                           t(out['cf_flips']).to(torch.int32))
        self.results['reference_corrupt_fold'] = {'max_err': 0.0,
                                                  'bound': 0.0}

        names = sorted(REF_TREE)
        grads = {nm: t(inp[f'tree_g_{nm}']) for nm in names}
        gbar = {nm: t(inp[f'tree_gbar_{nm}']) for nm in names}
        draws = TreeDraws([t(out[f'tree_rand_{i}']) for i in range(len(names))],
                          sign_u=t(out['tree_sign_u']),
                          mod_u=t(out['tree_mod_u']))
        fl = FLConfig(n_devices=k, wire='packed', channel='bernoulli',
                      collective='sharded')
        q, p = t(inp['tree_q']), t(inp['tree_p'])
        rows = m.rows(k)
        ghat, stats, diag = tr.spfl_aggregate_tree(
            {nm: g[rows] for nm, g in grads.items()}, gbar, q, p, fl, draws,
            mesh=m)
        for f in ('sign_ok', 'mod_ok'):
            assert np.array_equal(getattr(diag, f).numpy(),
                                  out[f'tree_{f}']), f
        gb_all = np.concatenate([np.ravel(inp[f'tree_gbar_{nm}'])
                                 for nm in names])
        bound = (2 * S + 1) * ulp_atol(1.0 / np.asarray(inp['tree_q']),
                                       stats['g_max'].numpy(), gb_all)
        err = max(float((ghat[nm].double()
                         - t(out[f'tree_ghat_{nm}']).double()).abs().max())
                  for nm in names)
        assert err <= bound, f'reference_tree: {err} > {bound}'
        for leaf in tree.leaves(ghat):
            _same_bits(m, leaf)
        self.results['reference_tree'] = {'max_err': err, 'bound': bound}


def worker_main(rank: int, world: int, port: int, out_dir: Path,
                ref_dir) -> None:
    import torch.distributed as tdist
    torch.set_num_threads(1)
    tdist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                             rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        grid = Grid(make_host_mesh())
        results = grid.run()
        if ref_dir is not None:
            grid.reference(Path(ref_dir))
        (out_dir / f'rank{rank}.json').write_text(json.dumps(results))
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's side (python tests/test_torch_sharded.py --reference DIR,
# with XLA_FLAGS=--xla_force_host_platform_device_count=4)
# ---------------------------------------------------------------------------

def reference_inputs(ref_dir: Path) -> None:
    rng = np.random.RandomState(7)
    k, n = REF_K, REF_N
    groups = -(-n // 32)
    arrs = dict(
        sp=rng.randint(0, 2 ** 32, (k, groups), dtype=np.uint64),
        qp=rng.randint(0, 2 ** 32, (k, groups * BITS), dtype=np.uint64),
        gbar=rng.rand(n).astype(np.float32),
        gmin=(rng.rand(k) * 0.1).astype(np.float32),
        mod_ok=rng.rand(k) < 0.7, w=(rng.rand(k) * 2).astype(np.float32),
        sign_ok=rng.rand(k) < 0.8,
        cf_words=rng.randint(0, 2 ** 32, (k, REF_W), dtype=np.uint64),
        cf_ber=(rng.rand(k) * 0.05).astype(np.float32),
        tree_q=(0.4 + 0.55 * rng.rand(k)).astype(np.float32),
        tree_p=(0.4 + 0.55 * rng.rand(k)).astype(np.float32))
    arrs['gmax'] = (arrs['gmin'] + rng.rand(k)).astype(np.float32)
    for nm, s in sorted(REF_TREE.items()):
        arrs[f'tree_g_{nm}'] = (rng.randn(k, *s) * 0.1).astype(np.float32)
        arrs[f'tree_gbar_{nm}'] = (rng.rand(*s) * 0.1).astype(np.float32)
    np.savez(ref_dir / 'inputs.npz', **arrs)


def reference_main(ref_dir: Path) -> None:
    """The reference's sharded calls on a forced 4-device mesh (its
    client axis 'data', Auto axis type) on the saved inputs; the tree's
    draws are derived from its key as the reference does
    (``test_torch_parity.tree_draws_from_key``)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import FLConfig as RFL
    from repro.core import transport as RTR
    from repro.kernels import ops as RK
    from repro.wire import corrupt as RWC
    from test_torch_parity import tree_draws_from_key
    assert len(jax.devices()) == 4, jax.devices()
    mesh = jax.make_mesh((4,), ('data',),
                         axis_types=(jax.sharding.AxisType.Auto,))
    inp = dict(np.load(ref_dir / 'inputs.npz'))
    u32 = {k: np.asarray(inp[k], np.uint32) for k in ('sp', 'qp',
                                                      'cf_words')}
    out = {}
    acc, votes = RK.spfl_aggregate_packed_sharded(
        u32['sp'], u32['qp'], inp['gbar'], inp['gmin'], inp['gmax'],
        inp['mod_ok'], inp['w'], inp['sign_ok'], REF_N, BITS, mesh=mesh)
    out['acc'], out['votes'] = np.asarray(acc), np.asarray(votes)
    key = jax.random.PRNGKey(11)
    rx, fold, flips = RK.corrupt_fold_words(
        key, jnp.asarray(u32['cf_words']), jnp.asarray(inp['cf_ber']),
        mesh=mesh)
    out['cf_rx'], out['cf_fold'] = np.asarray(rx), np.asarray(fold)
    out['cf_flips'] = np.asarray(flips)
    out['cf_seeds'] = np.asarray(RWC.seeds_from_key(key), np.uint32)
    names = sorted(REF_TREE)
    grads = {nm: jnp.asarray(inp[f'tree_g_{nm}']) for nm in names}
    gbar = {nm: jnp.asarray(inp[f'tree_gbar_{nm}']) for nm in names}
    fl = RFL(n_devices=REF_K, wire='packed', channel='bernoulli',
             collective='sharded')
    tkey = jax.random.PRNGKey(12)
    ghat, _, diag = RTR.spfl_aggregate_tree(
        grads, gbar, jnp.asarray(inp['tree_q']), jnp.asarray(inp['tree_p']),
        fl, tkey, mesh=mesh)
    for nm in names:
        out[f'tree_ghat_{nm}'] = np.asarray(ghat[nm])
    for f in ('sign_ok', 'mod_ok'):
        out[f'tree_{f}'] = np.asarray(getattr(diag, f))
    sizes = [int(np.prod(REF_TREE[nm])) for nm in names]
    draws = tree_draws_from_key(tkey, sizes, REF_K, 0, 'bernoulli')
    for i, r in enumerate(draws.rand):
        out[f'tree_rand_{i}'] = r.numpy()
    out['tree_sign_u'] = draws.sign_u.numpy()
    out['tree_mod_u'] = draws.mod_u.numpy()
    np.savez(ref_dir / 'reference.npz', **out)


# ---------------------------------------------------------------------------
# pytest's side
# ---------------------------------------------------------------------------

def _env(**extra):
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(SRC), str(HERE)] + ([env['PYTHONPATH']] if env.get('PYTHONPATH')
                                 else []))
    env.update(extra)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def reference_dir(tmp_path_factory):
    """The reference's subprocess, started here and waited for by the
    first S = 4 spawn (it runs beside the smaller world sizes)."""
    d = tmp_path_factory.mktemp('sharded_reference')
    reference_inputs(d)
    env = _env(XLA_FLAGS='--xla_force_host_platform_device_count=4',
               JAX_PLATFORMS='cpu')
    proc = subprocess.Popen([sys.executable, __file__, '--reference',
                             str(d)], env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        return d
    yield wait
    if proc.poll() is None:
        proc.kill()


_SPAWNS = {}


def spawn(world: int, out_dir: Path, ref_dir=None) -> dict:
    """Run ``world`` gloo ranks of the grid (once per world size) ->
    {rank: results}; a failing rank fails the caller with its errors."""
    if world in _SPAWNS:
        return _SPAWNS[world]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, '--worker', str(r), str(world), str(port),
         str(out_dir)] + ([str(ref_dir)] if ref_dir is not None else []),
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    for r, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p_ in procs:
                p_.kill()
            raise
        if proc.returncode:
            errs.append(f'rank {r}: {err[-3000:]}')
    results = None if errs else {
        r: json.loads((out_dir / f'rank{r}.json').read_text())
        for r in range(world)}
    _SPAWNS[world] = results if results is not None else errs
    return _SPAWNS[world]


@pytest.fixture(scope='module')
def grid(tmp_path_factory, reference_dir):
    def get(world):
        out = tmp_path_factory.mktemp(f'sharded_s{world}')
        res = spawn(world, out, reference_dir() if world == 4 else None)
        assert isinstance(res, dict), '\n'.join(res)
        return res
    return get


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('world', WORLDS)
def test_sharded_equals_gathered(grid, world, case):
    """Every rank of ``world`` ran ``case``: integers bit for bit, f32
    within S x the FMA-wobble bound (exact at S = 1), ĝ the same bits on
    every rank."""
    res = grid(world)
    for rank in range(world):
        got = {c: v for c, v in res[rank].items()
               if c == case or c.startswith(case + '.')}
        assert got, f'rank {rank} has no result for {case}'
        for c, v in got.items():
            assert v['max_err'] <= v['bound'], (c, v)
            if world == 1:
                assert v['max_err'] == 0.0, (c, v)


@pytest.mark.parametrize('case', REFERENCE_CASES)
def test_port_at_four_ranks_equals_the_reference_sharded(grid, case):
    """At S = 4 the port's sharded calls against the reference's own
    ``spfl_aggregate_packed_sharded``, ``corrupt_fold_words(mesh=)`` and
    ``spfl_aggregate_tree(collective='sharded')`` on a forced 4-device
    mesh: integers bit for bit, f32 within (2 S + 1) x the bound."""
    res = grid(4)
    for rank in range(4):
        v = res[rank][case]
        assert v['max_err'] <= v['bound'], (case, v)


def test_refusals_name_what_is_missing():
    """The reference's refusals, with its messages: 'sharded' needs the
    packed wire and a mesh; an unknown collective is refused."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import transport as tr
    from repro_torch.launch.mesh import make_host_mesh
    k, l = 3, 40
    grads = torch.randn(k, l)
    q = torch.ones(k)
    draws = tr.make_draws(k, l, 0, 'bernoulli', torch.device('cpu'),
                          torch.Generator().manual_seed(0),
                          torch.Generator().manual_seed(1))
    mesh = make_host_mesh()
    with pytest.raises(ValueError, match="requires wire='packed'"):
        tr.spfl_aggregate(grads, torch.zeros(l), q, q, BITS, 32, draws,
                          collective='sharded', mesh=mesh)
    with pytest.raises(ValueError, match='requires a mesh'):
        tr.spfl_aggregate(grads, torch.zeros(l), q, q, BITS, 32, draws,
                          wire='packed', collective='sharded')
    with pytest.raises(ValueError, match="'gather' or 'sharded'"):
        tr.spfl_aggregate(grads, torch.zeros(l), q, q, BITS, 32, draws,
                          wire='packed', collective='ring')
    fl = FLConfig(n_devices=k, collective='sharded')
    with pytest.raises(ValueError, match="requires wire='packed'"):
        tr.error_free_aggregate(grads, fl, draws, mesh=mesh)
    with pytest.raises(ValueError, match='requires a mesh'):
        tr.error_free_aggregate(grads, FLConfig(n_devices=k, wire='packed',
                                                collective='sharded'), draws)


def test_one_rank_mesh_without_a_group_is_the_gathered_call():
    """``make_host_mesh()`` with no process group: one rank, collectives
    the identity, the sharded transport bit for bit the gathered one."""
    from repro_torch.core import transport as tr
    from repro_torch.launch import mesh as M
    m = M.make_host_mesh()
    assert (m.rank, m.size, m.capturable) == (0, 1, True)
    assert M.n_clients(m) == 1 and M.client_axes(m) == ('data',)
    assert m.rows(5) == slice(0, 5) and m.k_local(5) == 5
    k, l = 4, 130
    gen = torch.Generator().manual_seed(3)
    grads = torch.randn(k, l, generator=gen)
    q = torch.full((k,), 0.6)
    draws = tr.make_draws(k, l, 0, 'bitlevel', torch.device('cpu'), gen,
                          torch.Generator().manual_seed(2))
    kw = dict(wire='packed', channel='bitlevel')
    a, ta = tr.spfl_aggregate(grads, torch.zeros(l), q, q, BITS, 32, draws,
                              **kw)
    b, tb = tr.spfl_aggregate(grads, torch.zeros(l), q, q, BITS, 32, draws,
                              collective='sharded', mesh=m, **kw)
    assert torch.equal(a, b)
    assert torch.equal(ta.sign_ok, tb.sign_ok)
    assert torch.equal(ta.sign_flips, tb.sign_flips)


def test_rows_and_blocks_of_a_ragged_grid():
    """The reference's block layout: rank r holds rows [r K_l, (r+1) K_l)
    of K padded to S K_l, K_l = ceil(K / S)."""
    from repro_torch.launch.mesh import ClientMesh
    m = ClientMesh()
    blocks = []
    for rank in range(4):
        m.rank, m.size = rank, 4
        blocks.append((m.rows(5), m.block(torch.arange(5), 5).tolist()))
    assert blocks == [(slice(0, 2), [0, 1]), (slice(2, 4), [2, 3]),
                      (slice(4, 5), [4, 0]), (slice(5, 5), [0, 0])]


if __name__ == '__main__':
    sys.path[:0] = [str(SRC), str(HERE)]
    if sys.argv[1] == '--worker':
        rank, world, port = (int(x) for x in sys.argv[2:5])
        worker_main(rank, world, port, Path(sys.argv[5]),
                    sys.argv[6] if len(sys.argv) > 6 else None)
    elif sys.argv[1] == '--reference':
        reference_main(Path(sys.argv[2]))
    else:
        raise SystemExit(f'unknown mode {sys.argv[1]}')
