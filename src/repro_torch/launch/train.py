"""LLM-scale FL training launcher — Algorithm 2 over the model zoo
(the port of ``repro.launch.train``).

The host loop (``round_fusion='none'``), each step: per-client gradients
-> the previous step's scalar report -> eq. (28) allocation -> the
simulated wireless uplink (the tree transport) -> aggregation -> the
global update.  The report is one step stale, with the reference's
approximation of v = <|g_k|, ḡ> by sqrt(||g_k||^2 ||ḡ||^2) / 10; the
allocation runs once ||ḡ||^2 > 0 (from step 1), on the host ('numpy') or
as one ``alloc_solve`` launch ('jax').

Fused rounds (``round_fusion`` 'eager' or 'scan', :func:`_run_fused`):
the whole round on the device with the exact report and the float32
in-round solve (``training.distributed.make_fused_fl_round``), in
segments of ``scan_segment_rounds`` (default ``telemetry_flush_every``)
rounds, each a CUDA graph on the card ('scan': one a segment; 'eager':
one round's, replayed); the host reads only at a segment's boundary.
Population mode (``population_n > 0``, promoted to 'scan' as the
reference does) samples a cohort a round from ``population_n`` devices;
each slot reads its device's data shard of ``population_shards``.

``collective='sharded'`` shards the clients over the initialised process
group (``launch.mesh.make_host_mesh``; one rank without one): each rank
holds the parameters and its rows' batches and runs the sharded
collective.  Under ``torchrun`` (one rank a card, NCCL):

  torchrun --nproc_per_node=S -m repro_torch.launch.train \
      --arch smollm-135m --clients 4 --wire packed --collective sharded

and on the CPU, gloo ranks with ``--device cpu``.  On one card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 4 --clients 4 --batch 8 --seq 256 --wire packed \
      --allocation-backend jax [--round-fusion scan]

runs on the CUDA card; ``--device cpu`` (or ``run(..., device='cpu')``)
takes the plain PyTorch path.  Random draws come from ``torch.Generator``s
seeded from ``seed``: the initial weights, the geometry, the bit
channel's seed words and the Bernoulli uniforms from one on the host,
the quantizer uniforms from one on the device, the fading normals (with
``allocation_cadence='per_round'``) from one seeded with the seed plus
``training.fl_loop.FADING_SEED_OFFSET``, and the stragglers' uniforms
from one seeded with the seed plus ``adversary.STRAGGLER_FOLD``; every
rank of a sharded run seeds them alike and draws the K clients' inputs.
Population cohorts come from the reference's key chain (``threefry``:
``fold_in(key(seed), 100)``, split once a round).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import adversary
from repro_torch import population as pop
from repro_torch import tree
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import allocation as alloc
from repro_torch.core import allocation_jax as alloc_jax
from repro_torch.core import channel as wireless
from repro_torch.core import threefry
from repro_torch.core import transport as tr
from repro_torch.core.mesh import ClientMesh
from repro_torch.data import synth_tokens
from repro_torch.device import DeviceLike, resolve
from repro_torch.launch import env
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tf
from repro_torch.obs import JsonlSink, run_manifest, to_row
from repro_torch.obs import ringbuf as obs_ring
from repro_torch.training import distributed as dist
from repro_torch.training.fl_loop import FADING_SEED_OFFSET

CHAIN_FOLD = 100      # the fused rounds' key chain: fold_in(key(seed), 100)


def promote(population_n: int, round_fusion: str,
            allocation_backend: str):
    """The reference's promotions, with its messages: population mode
    runs in fused rounds ('none' -> 'scan'), and fused rounds solve with
    the 'jax' engine ('numpy' -> 'jax').  -> (round_fusion,
    allocation_backend)."""
    if population_n > 0 and round_fusion == 'none':
        print("population mode: promoting round_fusion='none' -> 'scan' "
              '(cohorts are sampled in-trace)', flush=True)
        round_fusion = 'scan'
    if round_fusion != 'none' and allocation_backend != 'jax':
        print("round_fusion: promoting allocation_backend='numpy' -> "
              "'jax' (in-trace eq. (28) solve)", flush=True)
        allocation_backend = 'jax'
    return round_fusion, allocation_backend


def run(arch: Union[str, ModelConfig], steps: int, clients: int,
        batch: int, seq: int, transport_kind: str, allocator: str, lr: float,
        bandwidth_hz: float, tx_power_dbm: float, seed: int = 0,
        log_every: int = 1, wire: str = 'analytic',
        collective: str = 'gather', allocation_backend: str = 'numpy',
        allocation_cadence: str = 'static',
        round_fusion: str = 'none',
        allocation_tol: float = 0.0,
        allocation_early_exit: bool = True,
        attack: str = 'none', attack_frac: float = 0.25,
        attack_scale: float = 10.0, dropout_rate: float = 0.0,
        screen: bool = False, screen_z: float = 4.0,
        min_participation: float = 0.0,
        telemetry_path: Optional[str] = None,
        population_n: int = 0, cohort_size: int = 0,
        cohort_sampler: str = 'uniform',
        device: DeviceLike = None, scan_segment_rounds: int = 0,
        deterministic: Optional[bool] = None,
        segment_guard=None, channel: str = 'bernoulli') -> dict:
    """``steps`` steps of ``arch`` (a registry name, or a ``ModelConfig``
    such as a registry entry cut in depth) with ``clients`` clients of
    ``batch`` sequences of ``seq`` tokens each -> history {'loss', 'q', 'p',
    'step_s'} (a value a step: the mean loss, the mean q and p the step
    used, its wall seconds; fused rounds add 'capture_s', the seconds of
    the step's share of its segment spent capturing graphs).
    ``deterministic`` (default: under fused rounds) runs the gradient
    pass under ``torch.use_deterministic_algorithms``; ``segment_guard``
    (a context-manager factory) wraps the fused rounds' warm-up round and
    each segment's upload and launch (a profiler, or sync debug mode).
    ``channel``: the packet fates, 'bernoulli' (the reference launcher's,
    which has no such knob) or 'bitlevel' (with ``wire='packed'``)."""
    round_fusion, allocation_backend = promote(population_n, round_fusion,
                                               allocation_backend)
    if deterministic is None:
        deterministic = round_fusion != 'none'
    if deterministic:
        env.pin_cublas_workspace()
    dev = resolve(device)
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    fl = FLConfig(n_devices=clients, channel=channel, learning_rate=lr,
                  bandwidth_hz=bandwidth_hz, tx_power_dbm=tx_power_dbm,
                  allocator=allocator, transport=transport_kind, seed=seed,
                  wire=wire, collective=collective,
                  allocation_backend=allocation_backend,
                  allocation_cadence=allocation_cadence,
                  round_fusion=round_fusion,
                  allocation_tol=allocation_tol,
                  allocation_early_exit=allocation_early_exit,
                  attack=attack, attack_frac=attack_frac,
                  attack_scale=attack_scale, dropout_rate=dropout_rate,
                  screen=screen, screen_z=screen_z,
                  min_participation=min_participation,
                  population_n=population_n, cohort_size=cohort_size,
                  cohort_sampler=cohort_sampler,
                  scan_segment_rounds=scan_segment_rounds)
    # the client axis over whatever group is initialised (one rank
    # without one); the transports pad a ragged K
    sharded = collective == 'sharded'
    mesh = make_host_mesh() if sharded else ClientMesh()
    lead = mesh.rank == 0
    host_gen = torch.Generator().manual_seed(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tree.map(lambda t: t.to(dev), tf.init_params(cfg, host_gen))
    sizes = [int(p.numel()) for p in tree.leaves(params)]
    dim = sum(sizes)
    k_round = pop.validate(fl) if population_n else clients
    if lead:
        print(f'arch={arch} params={dim / 1e6:.1f}M clients={k_round}'
              + (f'/pop={population_n}' if population_n else '')
              + f' transport={transport_kind}'
              + (f' shards={mesh.size}' if sharded else ''),
              flush=True)

    p_w = np.full(clients, fl.tx_power_w)
    gains = gain_traj = None
    if not population_n:
        # static geometry; population mode draws each cohort's gains
        dist_m = wireless.sample_distances(host_gen, clients,
                                           fl.cell_radius_m)
        gains = wireless.path_gain(dist_m, fl.path_loss_exp)
        if fl.allocation_cadence == 'per_round':
            fade = torch.Generator().manual_seed(seed + FADING_SEED_OFFSET)
            gain_traj = wireless.block_fading_trajectory(
                torch.randn((steps, clients), generator=fade),
                torch.as_tensor(gains, dtype=torch.float32))
    straggler_gen = torch.Generator().manual_seed(
        seed + adversary.STRAGGLER_FOLD)

    sink = (JsonlSink(telemetry_path, run_manifest(
        fl, extra={'launcher': 'launch.train', 'arch': arch,
                   'round_fusion': fl.round_fusion}, device=dev,
        mesh=mesh if sharded else None))
        if telemetry_path and lead else None)
    # population mode makes population_shards data rows (device d reads
    # shard d mod S), not one a registered device
    n_rows = fl.population_shards if population_n else clients
    toks = synth_tokens(n_rows * batch * 4, seq + 1, cfg.vocab_size, seed)
    toks = torch.as_tensor(toks.reshape(n_rows, batch * 4, seq + 1),
                           device=dev)
    rows = mesh.rows(k_round)
    try:
        if fl.round_fusion != 'none':
            return _run_fused(cfg, fl, params, toks, gains, gain_traj,
                              batch, seq, steps, transport_kind, sink,
                              log_every, mesh, gen, host_gen, straggler_gen,
                              deterministic, lead, segment_guard)
        return _run_host(cfg, fl, params, toks[rows], gains, gain_traj, p_w,
                         batch, seq, steps, transport_kind, allocator, sink,
                         log_every, mesh, dev, gen, host_gen, straggler_gen,
                         deterministic, lead)
    finally:
        if sink is not None:
            sink.close()


def _run_host(cfg, fl: FLConfig, params, toks, gains, gain_traj, p_w,
              batch: int, seq: int, steps: int, transport_kind: str,
              allocator: str, sink, log_every: int, mesh, dev, gen,
              host_gen, straggler_gen, deterministic: bool,
              lead: bool) -> dict:
    """The host loop: a step a dispatch, the solve between steps on the
    previous step's report.  ``toks`` are this rank's clients'."""
    clients = fl.n_devices
    sizes = [int(p.numel()) for p in tree.leaves(params)]
    dim = sum(sizes)
    step = dist.make_fl_train_step(cfg, fl, transport_kind, mesh=mesh,
                                   deterministic=deterministic)
    gbar = dist.init_gbar(params)
    q = torch.ones((clients,), dtype=torch.float32, device=dev)
    p = torch.ones((clients,), dtype=torch.float32, device=dev)
    prev_stats = None
    history = {'loss': [], 'q': [], 'p': [], 'step_s': []}
    for n in range(steps):
        with record_function('step'):
            t0 = time.perf_counter()
            sl = (n * batch) % (batch * 4)
            batch_d = {'tokens': toks[:, sl:sl + batch, :seq]}
            gains_n = gains if gain_traj is None else np.asarray(
                gain_traj[n], np.float64)
            if prev_stats is not None and transport_kind == 'spfl':
                # Algorithm 2 steps 3-5 on the previous step's report
                g2 = np.asarray(prev_stats['g_norm_sq'], np.float64)
                gb2 = np.asarray(prev_stats['gbar_norm_sq'], np.float64)
                v = np.asarray(prev_stats['v'], np.float64)
                d2 = np.asarray(prev_stats['d2'], np.float64)
                if gb2.max() > 0:
                    with record_function('step/solve'):
                        q, p = _allocate(fl, allocator, g2, gb2, v, d2,
                                         gains_n, p_w, dim, dev)
            draws = tr.make_tree_draws(clients, sizes, 0, fl.channel, dev,
                                       gen, host_gen, kind=transport_kind)
            active_u = (torch.rand((clients,), generator=straggler_gen)
                        .to(dev) if fl.dropout_rate > 0.0 else None)
            params, gbar, m = step(params, batch_d, gbar, q, p, draws,
                                   active_u)
            gb_norm2 = sum(torch.stack([
                torch.sum(torch.square(g)) for g in tree.leaves(gbar)
            ]).tolist())
            # v needs <|g_k|, ḡ>: the reference approximates it from the
            # norms the clients report (an exact v needs another tree pass)
            g2_k = m['g_norm_sq'].cpu().numpy()
            d2 = tr.delta_sq_tree({'g_min': m['g_min'],
                                   'g_max': m['g_max'], 'dim': dim},
                                  fl.quant_bits)
            prev_stats = {
                'g_norm_sq': g2_k,
                'gbar_norm_sq': np.full(clients, gb_norm2),
                'v': np.sqrt(g2_k * gb_norm2) * 0.1,
                'd2': d2.cpu().numpy(),
            }
            dt = time.perf_counter() - t0
        loss = float(m['loss'])
        q_mean, p_mean = float(torch.mean(q)), float(torch.mean(p))
        history['loss'].append(loss)
        history['q'].append(q_mean)
        history['p'].append(p_mean)
        history['step_s'].append(dt)
        if sink is not None:
            row = to_row(m['telemetry'].to_host(), round_idx=n)
            row['loss'] = loss
            row['step_s'] = dt
            sink.write_round(row)
        if lead and n % log_every == 0:
            print(f'step {n:4d} loss {loss:.4f} q̄ {q_mean:.3f} '
                  f'p̄ {p_mean:.3f} sign_ok '
                  f'{int(torch.sum(m["sign_ok"]))}/{clients} {dt:.2f}s',
                  flush=True)
    return history


def _run_fused(cfg, fl: FLConfig, params, toks, gains, gain_traj,
               batch: int, seq: int, steps: int, transport_kind: str, sink,
               log_every: int, mesh, gen, host_gen, straggler_gen,
               deterministic: bool, lead: bool, segment_guard=None) -> dict:
    """The segment dispatcher of fused rounds: at each segment's boundary
    it draws the segment's host-made inputs (the cohorts from the key
    chain, the transport's host draws, the straggler uniforms, the fading
    rows; the same generators in the same order as the host loop),
    launches the segment (``distributed.make_fused_fl_scan``: one graph,
    or one graph a round), then flushes the ring and logs: the host's
    only reads.  History and telemetry rows are the reference's."""
    seg_len = fl.scan_segment_rounds or max(1, fl.telemetry_flush_every)
    population = fl.population_n > 0
    k = pop.cohort_size(fl) if population else fl.n_devices
    pool = toks if population else toks[mesh.rows(k)]
    n_slots = pool.shape[1] // batch
    offsets = torch.arange(batch, device=pool.device)

    def batch_fn(n, shards):
        # a dynamic slice of the resident pool keyed on the device round
        # index, and in population mode the cohort's shards
        rows = pool if shards is None else pool.index_select(0, shards)
        idx = (n % n_slots) * batch + offsets
        return {'tokens': rows.index_select(1, idx)[..., :seq]}

    segment, init_carry = dist.make_fused_fl_scan(
        cfg, fl, gains, batch_fn, transport_kind=transport_kind, mesh=mesh,
        deterministic=deterministic)
    carry = init_carry(params, seg_len)
    if segment_guard is not None:
        carry.guard = segment_guard
    n_leaves = len(carry.sizes)
    if population:
        streams = pop.stream_keys(pop.population_key(fl.seed))
        chain = threefry.fold_in(threefry.key(fl.seed), CHAIN_FOLD)
        per_round = (fl.allocation_cadence == 'per_round'
                     and transport_kind == 'spfl')

    history = {'loss': [], 'q': [], 'p': [], 'step_s': [], 'capture_s': []}
    done = 0
    while done < steps:
        m = min(seg_len, steps - done)
        t0 = time.perf_counter()
        captured = carry.capture_s
        slots = []
        for n in range(done, done + m):
            cohort = row_gains = None
            if population:
                chain, kr = threefry.split(chain)
                cohort = pop.cohort_columns(pop.draw_cohort(
                    kr, streams, fl, n, gains=transport_kind == 'spfl',
                    shadowing=per_round, byzantine=fl.attack != 'none'),
                    fl.population_shards)
            elif gain_traj is not None:
                row_gains = gain_traj[n]
            slots.append(dist.round_host_inputs(
                fl, k, n_leaves, n, host_gen, straggler_gen, transport_kind,
                gains=row_gains, cohort=cohort))
        losses = segment(carry, slots, gen)
        # ---- the segment boundary: the run's only host reads ----
        recs, carry.ring = obs_ring.flush(carry.ring)
        losses_h = losses.cpu().numpy()
        dt = time.perf_counter() - t0
        cap = carry.capture_s - captured
        for i, rec in enumerate(recs):
            row = to_row(rec)
            row['loss'] = float(losses_h[i])
            row['step_s'] = dt / m
            history['loss'].append(float(losses_h[i]))
            history['q'].append(row['q_mean'])
            history['p'].append(row['p_mean'])
            history['step_s'].append(dt / m)
            history['capture_s'].append(cap / m)
            if sink is not None:
                sink.write_round(row)
        if lead and (done // seg_len) % max(1, log_every) == 0:
            print(f'seg [{done:4d}..{done + m - 1:4d}] '
                  f'loss {losses_h[-1]:.4f} '
                  f'q̄ {history["q"][-1]:.3f} p̄ {history["p"][-1]:.3f} '
                  f'{dt:.2f}s ({dt / m:.2f}s/round, capture {cap:.2f}s)',
                  flush=True)
        done += m
    return history


def _allocate(fl: FLConfig, allocator: str, g2, gb2, v, d2, gains, p_w,
              dim: int, dev):
    """Eq. (28) on the scalar report -> (q, p) f32 on ``dev``: one
    ``alloc_solve`` launch ('jax'; the plain solver on the CPU) or the
    host NumPy solver ('numpy')."""
    if fl.allocation_backend == 'jax':
        sol = alloc_jax.solve_from_stats(
            g2, gb2, v, d2, gains, p_w, dim, fl, allocator,
            max_iters=fl.allocation_max_iters or 6,
            tol=fl.allocation_tol or 1e-5,
            early_exit=fl.allocation_early_exit, device=dev)
        return sol.q.to(torch.float32), sol.p.to(torch.float32)
    prob = alloc.problem_from_stats(g2, gb2, v, d2, gains, p_w, dim, fl)
    sol = alloc.solve(prob, allocator)
    return (torch.as_tensor(sol.q, dtype=torch.float32, device=dev),
            torch.as_tensor(sol.p, dtype=torch.float32, device=dev))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='smollm-135m-reduced')
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--clients', type=int, default=4)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=256)
    ap.add_argument('--transport', default='spfl',
                    choices=['spfl', 'error_free'])
    ap.add_argument('--allocator', default='barrier',
                    choices=['alternating', 'barrier', 'uniform'])
    ap.add_argument('--lr', type=float, default=0.05)
    ap.add_argument('--bandwidth-hz', type=float, default=10e9,
                    help='scaled-up band for LLM-size payloads')
    ap.add_argument('--tx-power-dbm', type=float, default=-4.0)
    ap.add_argument('--wire', default='analytic',
                    choices=['analytic', 'packed'])
    ap.add_argument('--collective', default='gather',
                    choices=['gather', 'sharded'],
                    help="'sharded' keeps the packed uplink reduce "
                         'shard-local over the initialised process group '
                         '(requires --wire packed; torchrun)')
    ap.add_argument('--allocation-backend', default='numpy',
                    choices=['numpy', 'jax'],
                    help="'jax' solves eq. (28) in one alloc_solve kernel "
                         'launch on the card')
    ap.add_argument('--allocation-cadence', default='static',
                    choices=['static', 'per_round'],
                    help="'per_round' evolves the channel gains every "
                         'step by the seeded block-fading process')
    ap.add_argument('--round-fusion', default='none',
                    choices=['none', 'eager', 'scan'],
                    help="'scan' runs a segment of rounds as one CUDA "
                         "graph (no host read between flushes; needs "
                         "--allocation-backend jax on spfl); 'eager' one "
                         "round's graph, replayed")
    ap.add_argument('--allocation-tol', type=float, default=0.0,
                    help='relative-objective convergence tolerance of '
                         'the eq. (28) outer loop (0 = 1e-5)')
    ap.add_argument('--allocation-early-exit', default=True,
                    action=argparse.BooleanOptionalAction,
                    help='leave the solver loops as soon as the iterate '
                         'converges (bit-identical to the fixed-trip '
                         'schedule)')
    ap.add_argument('--attack', default='none',
                    choices=['none', 'signflip', 'scaled', 'labelflip'],
                    help="byzantine cohort model; 'labelflip' has no "
                         'packet effect on synthetic tokens')
    ap.add_argument('--attack-frac', type=float, default=0.25)
    ap.add_argument('--attack-scale', type=float, default=10.0)
    ap.add_argument('--dropout-rate', type=float, default=0.0,
                    help='per-step client dropout probability (i.i.d.)')
    ap.add_argument('--screen', default=False,
                    action=argparse.BooleanOptionalAction,
                    help='the norm-report byzantine screen')
    ap.add_argument('--screen-z', type=float, default=4.0)
    ap.add_argument('--min-participation', type=float, default=0.0)
    ap.add_argument('--telemetry-out', default=None,
                    help='write per-step RoundTelemetry JSONL (and the run '
                         'manifest) to this path')
    ap.add_argument('--population-n', type=int, default=0,
                    help='registered-device population N (0 = the cohort '
                         'is the population; N > 0 samples a cohort a '
                         'round, in fused rounds)')
    ap.add_argument('--cohort-size', type=int, default=0)
    ap.add_argument('--cohort-sampler', default='uniform',
                    choices=['uniform', 'availability'])
    ap.add_argument('--device', default=None,
                    help="'cpu' for the plain PyTorch path (default: the "
                         'CUDA card)')
    args = ap.parse_args(argv)
    env.configure_driver(args)
    _init_group(args)
    return run(args.arch, args.steps, args.clients, args.batch, args.seq,
               args.transport, args.allocator, args.lr, args.bandwidth_hz,
               args.tx_power_dbm, wire=args.wire, collective=args.collective,
               allocation_backend=args.allocation_backend,
               allocation_cadence=args.allocation_cadence,
               round_fusion=args.round_fusion,
               allocation_tol=args.allocation_tol,
               allocation_early_exit=args.allocation_early_exit,
               attack=args.attack, attack_frac=args.attack_frac,
               attack_scale=args.attack_scale,
               dropout_rate=args.dropout_rate, screen=args.screen,
               screen_z=args.screen_z,
               min_participation=args.min_participation,
               telemetry_path=args.telemetry_out,
               population_n=args.population_n,
               cohort_size=args.cohort_size,
               cohort_sampler=args.cohort_sampler, device=args.device)


def _init_group(args) -> None:
    """Under ``torchrun`` with ``--collective sharded``: the default
    process group from its environment (NCCL, one card a local rank; gloo
    with ``--device cpu``)."""
    if args.collective != 'sharded' or 'WORLD_SIZE' not in os.environ:
        return
    import torch.distributed as tdist
    if tdist.is_initialized():
        return
    on_cpu = args.device == 'cpu'
    if not on_cpu:
        local = int(os.environ.get('LOCAL_RANK', 0))
        torch.cuda.set_device(local)
        args.device = f'cuda:{local}'
    tdist.init_process_group('gloo' if on_cpu else 'nccl')


if __name__ == '__main__':
    main()
