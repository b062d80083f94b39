"""LLM-scale FL training launcher — Algorithm 2 over the dense model zoo
(the port of the host loop of ``repro.launch.train``).

Each step: per-client gradients -> the previous step's scalar report ->
eq. (28) allocation -> the simulated wireless uplink (the tree transport)
-> aggregation -> the global update.  The report is one step stale, with
the reference's approximation of v = <|g_k|, ḡ> by sqrt(||g_k||^2
||ḡ||^2) / 10; the allocation runs once ||ḡ||^2 > 0 (from step 1), on
the host ('numpy') or as one ``alloc_solve`` launch ('jax').

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 4 --clients 4 --batch 8 --seq 256 --wire packed \\
      --allocation-backend jax

runs on the CUDA card; ``--device cpu`` (or ``run(..., device='cpu')``)
takes the plain PyTorch path.  Random draws come from ``torch.Generator``s
seeded from ``seed``: the initial weights, the geometry, the bit
channel's seed words and the Bernoulli uniforms from one on the host,
the quantizer uniforms from one on the device, the fading normals (with
``allocation_cadence='per_round'``) from one seeded with the seed plus
``training.fl_loop.FADING_SEED_OFFSET``, and the stragglers' uniforms
from one seeded with the seed plus ``adversary.STRAGGLER_FOLD``.

Not here yet (``NotImplementedError``, ROADMAP Queue 1 item 12): fused
rounds (``round_fusion`` 'eager' or 'scan'), population mode
(``population_n > 0``) and ``collective='sharded'``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import adversary
from repro_torch import tree
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import allocation as alloc
from repro_torch.core import allocation_jax as alloc_jax
from repro_torch.core import channel
from repro_torch.core import transport as tr
from repro_torch.data import synth_tokens
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import transformer as tf
from repro_torch.obs import JsonlSink, run_manifest, to_row
from repro_torch.training import distributed as dist
from repro_torch.training.fl_loop import FADING_SEED_OFFSET

LATER = 'ROADMAP Queue 1 item 12'


def check_supported(round_fusion: str, population_n: int,
                    collective: str) -> None:
    """Raise ``NotImplementedError`` on the knobs of this launcher the port
    does not run yet."""
    if round_fusion != 'none':
        raise NotImplementedError(
            f'round_fusion={round_fusion!r} on the LLM-scale launcher (fused '
            f'LLM rounds) is {LATER}')
    if population_n > 0:
        raise NotImplementedError(
            f'population mode on the LLM-scale launcher is {LATER}')
    if collective == 'sharded':
        raise NotImplementedError(tr.SHARDED_LATER)


def run(arch: str, steps: int, clients: int, batch: int, seq: int,
        transport_kind: str, allocator: str, lr: float,
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
        device: DeviceLike = None) -> dict:
    """``steps`` steps of ``arch`` with ``clients`` clients of ``batch``
    sequences of ``seq`` tokens each -> history {'loss', 'q', 'p',
    'step_s'} (a value a step: the mean loss, the mean q and p the step
    used, its wall seconds)."""
    check_supported(round_fusion, population_n, collective)
    dev = resolve(device)
    cfg = get_arch(arch)
    fl = FLConfig(n_devices=clients, learning_rate=lr,
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
                  cohort_sampler=cohort_sampler)
    host_gen = torch.Generator().manual_seed(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tree.map(lambda t: t.to(dev), tf.init_params(cfg, host_gen))
    sizes = [int(p.numel()) for p in tree.leaves(params)]
    dim = sum(sizes)
    print(f'arch={arch} params={dim / 1e6:.1f}M clients={clients} '
          f'transport={transport_kind}', flush=True)

    p_w = np.full(clients, fl.tx_power_w)
    dist_m = channel.sample_distances(host_gen, clients, fl.cell_radius_m)
    gains = channel.path_gain(dist_m, fl.path_loss_exp)
    gain_traj = None
    if fl.allocation_cadence == 'per_round':
        fade = torch.Generator().manual_seed(seed + FADING_SEED_OFFSET)
        gain_traj = channel.block_fading_trajectory(
            torch.randn((steps, clients), generator=fade),
            torch.as_tensor(gains, dtype=torch.float32))
    straggler_gen = torch.Generator().manual_seed(
        seed + adversary.STRAGGLER_FOLD)

    sink = (JsonlSink(telemetry_path, run_manifest(
        fl, extra={'launcher': 'launch.train', 'arch': arch,
                   'round_fusion': fl.round_fusion}, device=dev))
        if telemetry_path else None)
    toks = synth_tokens(clients * batch * 4, seq + 1, cfg.vocab_size, seed)
    toks = torch.as_tensor(toks.reshape(clients, batch * 4, seq + 1),
                           device=dev)

    step = dist.make_fl_train_step(cfg, fl, transport_kind)
    gbar = dist.init_gbar(params)
    q = torch.ones((clients,), dtype=torch.float32, device=dev)
    p = torch.ones((clients,), dtype=torch.float32, device=dev)
    prev_stats = None
    history = {'loss': [], 'q': [], 'p': [], 'step_s': []}
    try:
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
            if n % log_every == 0:
                print(f'step {n:4d} loss {loss:.4f} q̄ {q_mean:.3f} '
                      f'p̄ {p_mean:.3f} sign_ok '
                      f'{int(torch.sum(m["sign_ok"]))}/{clients} {dt:.2f}s',
                      flush=True)
    finally:
        if sink is not None:
            sink.close()
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
                    help="'sharded' is not ported yet (ROADMAP Queue 1 "
                         'item 12)')
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
                    help="fused LLM rounds ('eager', 'scan') are not "
                         'ported yet (ROADMAP Queue 1 item 12)')
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
                    help='population mode is not ported yet (ROADMAP '
                         'Queue 1 item 12)')
    ap.add_argument('--cohort-size', type=int, default=0)
    ap.add_argument('--cohort-sampler', default='uniform',
                    choices=['uniform', 'availability'])
    ap.add_argument('--device', default=None,
                    help="'cpu' for the plain PyTorch path (default: the "
                         'CUDA card)')
    args = ap.parse_args(argv)
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


if __name__ == '__main__':
    main()
