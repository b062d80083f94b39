"""LLM-scale federated train step — SP-FL as the gradient transport of a
data-parallel training step (the port of ``repro.training.distributed``).

Each of the K clients takes the gradient of its own batch
(``torch.func.vmap`` over the clients, the reference's
``jax.vmap(jax.value_and_grad)``) into (K, ...) leaves, and the tree
transport (``core.transport.spfl_aggregate_tree`` or
``error_free_aggregate_tree``) carries them to the PS: on the packed
wire each leaf is one ``quantize_pack`` and one ``spfl_accumulate``
launch, and on the bit channel two ``corrupt_fold`` launches (sign and
modulus passes).  The update is plain GD in float32, cast back to the
parameters' dtype, and ḡ becomes |ĝ| in float32.

``collective='sharded'`` (with a ``core.mesh.ClientMesh``): each rank
holds a replica of the parameters and the batches of its rows of the K
clients (the reference's client axis over ('pod', 'data')), takes their
gradients (vmapped over its rows), and runs the tree transport sharded:
the per-client report crosses ranks in one ``all_gather`` of (K,)
vectors, each leaf's partial sum in one ``all_reduce``, and every rank
applies the same ĝ.  The reference's 'model' axis (tensor parallelism)
takes ``training.model_axis``'s step (a ``launch.mesh.ProductionMesh``).

The host step (:func:`make_fl_train_step`) takes the channel's (q, p) as
inputs: the launcher (``launch.train``) solves eq. (28) between steps on
the per-client scalars it returns, one step stale.  The fused round
(:func:`make_fused_fl_round`) is the whole Algorithm-2 round on the
device: the gradients, the tree stats and the exact v_k = <|g_k|, ḡ>,
the float32 eq. (28) solve (one ``alloc_solve_f32`` launch, uniform
while ||ḡ||^2 = 0, decided on the device), the transport, the update,
the ḡ roll and the condensed record, with no host read.
:func:`make_fused_fl_scan` runs segments of such rounds as CUDA graphs
('scan': one graph a segment length; 'eager': one round's graph,
replayed), reusing ``training.fused``'s staging and capture.  The random
inputs are explicit (``core.transport.TreeDraws``, the straggler
uniforms, the population cohort): the dispatcher draws them at a
segment's boundary, from the same generators in the same order as the
host loop.

The profiler spans ``step/gradients``, ``step/stats``,
``step/transport`` and ``step/update`` split a host step (the launcher
adds ``step/solve``); ``round/gradients``, ``round/stats``,
``round/solve``, ``round/transport`` and ``round/update`` a fused round.
"""
from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import grad_and_value, vmap
from torch.profiler import record_function

from repro_torch import adversary
from repro_torch import population as pop
from repro_torch import tree
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core import allocation_jax as alloc_jax
from repro_torch.core import transport as tr
from repro_torch.core.mesh import ClientMesh
from repro_torch.kernels import ops
from repro_torch.launch.mesh import ProductionMesh
from repro_torch.models import transformer as tf
from repro_torch.obs import ringbuf as obs_ring
from repro_torch.obs.record import round_scalars
from repro_torch.training import fused
from repro_torch.training.optimizer import Optimizer, sgd

Tensor = torch.Tensor
TRANSPORTS = ('spfl', 'error_free')


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True):
    """``torch.use_deterministic_algorithms(True)`` inside the block (a
    process-wide flag, restored after): the gradient pass's embedding
    backward and the loss's gather backward then take their deterministic
    kernels, so a replayed round equals an eager one bit for bit."""
    if not on:
        yield
        return
    before = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before, warn_only=warn)


def init_gbar(params) -> Any:
    """Compensation modulus tree (last_global style), float32 zeros."""
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _adversary_closures(fl: FLConfig):
    """The byzantine mask of the LLM-scale step (fixed for the run: the
    first floor(attack_frac K) of a permutation from a host generator
    seeded with the seed plus ``adversary.BYZ_FOLD``; on the CPU) and the
    per-step dropout: i.i.d. each step from K uniforms, ``u >=
    dropout_rate`` (the reference draws them from the step key's
    ``STRAGGLER_FOLD`` stream; no sticky chain at this scale).
    'labelflip' has no packet effect on token batches, so its mask stays
    unused in the transport."""
    k = fl.n_devices
    byz = None
    if fl.attack != 'none' and not fl.population_n:
        perm = torch.randperm(k, generator=torch.Generator().manual_seed(
            fl.seed + adversary.BYZ_FOLD))
        byz = adversary.byzantine_mask(k, fl.attack_frac, perm)

    def draw_active(u: Optional[Tensor]) -> Optional[Tensor]:
        if fl.dropout_rate <= 0.0:
            return None
        if u is None:
            raise ValueError('dropout_rate > 0: the step needs the (K,) '
                             'straggler uniforms')
        return adversary.bernoulli_active(u, fl.dropout_rate)

    return byz, draw_active


def client_batch_shapes(cfg: ModelConfig, n_clients: int,
                        global_batch: int, seq_len: int) -> Dict[str, Any]:
    """(shape, dtype) of each array of one training batch, client-major."""
    if global_batch % n_clients:
        raise ValueError(f'global batch {global_batch} does not split over '
                         f'{n_clients} clients')
    b = global_batch // n_clients
    shapes = {'tokens': ((n_clients, b, seq_len), torch.int32)}
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        shapes['prefix'] = ((n_clients, b, cfg.n_prefix_tokens,
                             cfg.frontend_embed_dim), torch.bfloat16)
    return shapes


def client_grads(params, cfg: ModelConfig, tokens: Tensor,
                 deterministic: bool = False,
                 prefix: Optional[Tensor] = None) -> Tuple[Tensor, Any]:
    """Each client's loss and gradient on its own batch: (b, T) of the
    (K, b, T) ``tokens`` and, for a vision model, (b, P, E) of the (K,
    b, P, E) ``prefix`` -> (losses (K,) f32, gradient tree with (K, ...)
    leaves in the parameters' dtypes): ``torch.func.vmap`` of
    ``grad_and_value`` over the client axis, the reference's
    ``jax.vmap(jax.value_and_grad)`` over the batch dict: one batched
    pass for all K clients (fewer, larger launches than a loop over the
    clients; all K clients' activations at once).  ``deterministic``:
    under :func:`deterministic_algorithms`."""
    leaves = [p.detach() for p in tree.leaves(params)]

    def loss(ls, toks, pre):
        return tf.loss_fn(tree.unflatten(params, ls), cfg, toks, pre)

    with deterministic_algorithms(deterministic):
        grads, losses = vmap(grad_and_value(loss),
                             in_dims=(None, 0, None if prefix is None
                                      else 0))(leaves, tokens, prefix)
    return losses, tree.unflatten(params, list(grads))


def _step_mesh(fl: FLConfig, mesh, maker: str) -> ClientMesh:
    """The mesh a step runs on: ``mesh`` under 'sharded' (the reference's
    refusal without one), the one-rank mesh under 'gather'."""
    if fl.collective != 'sharded':
        return ClientMesh()
    if mesh is None:
        raise ValueError("fl.collective='sharded' needs the mesh passed "
                         f'into {maker}')
    return mesh


def _check_block(mesh, k: int, rows: int) -> None:
    """A sharded step takes this rank's clients' batches: at least one."""
    tr.check_rows(mesh, k, rows)
    if rows == 0:
        raise ValueError(f"collective='sharded': rank {mesh.rank} of "
                         f'{mesh.size} holds none of the {k} clients '
                         f'(blocks of {mesh.k_local(k)} rows)')


def _gather_report(mesh, k: int, losses: Tensor, stats: dict,
                   *more: Tensor):
    """The K clients' losses, tree stats and ``more`` per-client vectors
    from each rank's rows, in one ``all_gather``."""
    losses, g2, g_min, g_max, *more = tr.gather_clients(
        mesh, k, losses, stats['g2'], stats['g_min'], stats['g_max'], *more)
    return losses, dict(stats, g2=g2, g_min=g_min, g_max=g_max), more


def tree_transport(transport_kind: str, grads, gbar, q: Tensor, p: Tensor,
                   fl: FLConfig, draws: tr.TreeDraws, stats: dict, mesh,
                   adversary_closures, active_u: Optional[Tensor] = None):
    """The step's tree transport: ``spfl_aggregate_tree`` with the
    adversarial knobs of ``fl`` (``adversary_closures``, from
    :func:`_adversary_closures`), or ``error_free_aggregate_tree``.  ->
    (ĝ, stats, telemetry)."""
    with record_function('step/transport'):
        if transport_kind == 'spfl':
            byz_cpu, draw_active = adversary_closures
            byz = None if byz_cpu is None else byz_cpu.to(q.device)
            return tr.spfl_aggregate_tree(
                grads, gbar, q, p, fl, draws, stats=stats, mesh=mesh,
                attack=fl.attack, byz_mask=byz,
                attack_scale=fl.attack_scale,
                active=draw_active(active_u), screen=fl.screen,
                screen_z=fl.screen_z,
                min_participation=fl.min_participation)
        return tr.error_free_aggregate_tree(grads, fl, draws, stats=stats,
                                            mesh=mesh, k=q.shape[0])


def step_metrics(losses: Tensor, stats: dict, diag, q: Tensor, p: Tensor
                 ) -> dict:
    """The host step's metrics (the reference's)."""
    diag = diag.with_allocation(q, p)
    return {
        'loss': torch.mean(losses),
        'client_losses': losses,
        'g_norm_sq': stats['g2'],            # -> the host allocator
        'g_min': stats['g_min'],
        'g_max': stats['g_max'],
        'sign_ok': diag.sign_ok,
        'mod_ok': diag.mod_ok,
        'telemetry': diag,
        **round_scalars(diag),
    }


def make_fl_train_step(cfg: ModelConfig, fl: FLConfig,
                       transport_kind: str = 'spfl', mesh=None,
                       deterministic: bool = False):
    """Returns ``train_step(params, batch, gbar, q, p, draws,
    active_u=None) -> (new_params, new_gbar, metrics)``: ``batch`` holds
    (K, b, T) int ``tokens`` and, for a vision model, the (K, b, P, E)
    ``prefix`` embeddings, ``draws`` the step's ``TreeDraws``,
    ``active_u`` the (K,) straggler uniforms (``fl.dropout_rate > 0``).
    The metrics are the reference's: the mean and per-client losses, the
    per-client stats (``g_norm_sq``, ``g_min``, ``g_max``) the launcher's
    allocator reads, ``sign_ok``/``mod_ok``, the step's
    ``RoundTelemetry`` under 'telemetry' and its ``round_scalars``.

    ``mesh`` is required when ``fl.collective='sharded'``: ``tokens``
    are then this rank's rows of the K = len(q) clients
    (``mesh.rows(K)``, at least one), everything else is global, and the
    metrics are the K clients' on every rank.  A production mesh
    (``launch.mesh.ProductionMesh``, with a 'model' axis) takes the step
    of ``training.model_axis``: the parameters and ḡ are then the rank's
    blocks.  ``deterministic`` runs the gradient pass under
    :func:`deterministic_algorithms`."""
    if transport_kind not in TRANSPORTS:
        raise ValueError(f'LLM-scale transport must be spfl|error_free, '
                         f'got {transport_kind!r}')
    if isinstance(mesh, ProductionMesh):
        from repro_torch.training import model_axis
        return model_axis.make_fl_train_step(cfg, fl, transport_kind, mesh,
                                             deterministic)
    mesh = _step_mesh(fl, mesh, 'make_fl_train_step')
    lr = fl.learning_rate
    adversary_closures = _adversary_closures(fl)

    def train_step(params, batch, gbar, q, p, draws: tr.TreeDraws,
                   active_u: Optional[Tensor] = None):
        k = q.shape[0]
        _check_block(mesh, k, batch['tokens'].shape[0])
        with record_function('step/gradients'):
            losses, grads = client_grads(params, cfg, batch['tokens'],
                                         deterministic,
                                         prefix=batch.get('prefix'))
        with record_function('step/stats'):
            stats = tr.tree_client_stats(grads)
            losses, stats, _ = _gather_report(mesh, k, losses, stats)
        ghat, stats, diag = tree_transport(transport_kind, grads, gbar, q, p,
                                           fl, draws, stats, mesh,
                                           adversary_closures, active_u)
        del grads
        with record_function('step/update'):
            new_params = tree.map(
                lambda pp, g: (pp.to(torch.float32) - lr * g).to(pp.dtype),
                params, ghat)
            new_gbar = tree.map(torch.abs, ghat)
        return new_params, new_gbar, step_metrics(losses, stats, diag, q, p)

    return train_step


def exact_v(grads, gbar) -> Tensor:
    """v_k = <|g_k|, ḡ> of each client over the whole tree, float32 (leaf
    by leaf, each a row sum): the fused round's exact scalar, which the
    host launcher can only approximate."""
    leaves = tree.leaves(grads)
    k = leaves[0].shape[0]
    v = torch.zeros((k,), dtype=torch.float32, device=leaves[0].device)
    for g, b in zip(leaves, tree.leaves(gbar)):
        v = v + torch.sum(torch.abs(g.to(torch.float32)).reshape(k, -1)
                          * b.to(torch.float32).reshape(1, -1), dim=1)
    return v


def gbar_norm_sq(gbar) -> Tensor:
    """||ḡ||^2 over the whole tree, a float32 device scalar (the
    compensation tree is shared at LLM scale)."""
    out = torch.zeros((), dtype=torch.float32,
                      device=tree.leaves(gbar)[0].device)
    for b in tree.leaves(gbar):
        out = out + torch.sum(torch.square(b.to(torch.float32)))
    return out


def make_fused_fl_round(cfg: ModelConfig, fl: FLConfig,
                        optimizer: Optional[Optimizer] = None,
                        transport_kind: str = 'spfl', mesh=None,
                        deterministic: bool = True):
    """The WHOLE Algorithm-2 round as one body of device operations — the
    LLM-scale twin of the CNN's fused round.

    Returns ``round_fn(params, opt_state, gbar, batch, gains, draws,
    round_idx, cohort=None, active_u=None) -> (params', opt_state',
    gbar', rec, loss)``: per-client gradients -> tree stats and the exact
    v_k -> the float32 eq. (28) solve (``problem_from_stats(dtype=
    float32)`` and one ``ops.alloc_solve`` launch, ``alloc_solve_f32`` on
    the card, at the uniform point while ||ḡ||^2 = 0: the solver's gate,
    the reference's ``lax.cond``, with no host read) -> the tree
    transport on ``draws`` -> ``optimizer.update`` -> the ḡ roll -> the
    condensed record (``round_idx`` a device scalar).  ``gains`` (K,) are
    the round's gains (ignored in population mode, where ``cohort``, a
    ``population.CohortRound``, brings the cohort's gains, power budgets,
    byzantine membership and arrivals); ``active_u`` the straggler
    uniforms (``fl.dropout_rate > 0``).

    Unlike the host launcher's one-step-stale report, the solve sees the
    round's exact per-client stats.  ``optimizer`` defaults to plain SGD
    at ``fl.learning_rate`` (the host step's update, bit for bit).
    ``mesh`` is required when ``fl.collective='sharded'`` (``batch``
    then holds this rank's rows; the report crosses ranks in one
    ``all_gather``)."""
    mesh = _step_mesh(fl, mesh, 'make_fused_fl_round')
    if transport_kind not in TRANSPORTS:
        raise ValueError(f'LLM-scale transport must be spfl|error_free, '
                         f'got {transport_kind!r}')
    if transport_kind == 'spfl' and fl.allocation_backend != 'jax':
        raise ValueError("fused rounds require allocation_backend='jax' "
                         "(eq. (28) must solve in-trace)")
    opt = optimizer if optimizer is not None else sgd(fl.learning_rate)
    population = fl.population_n > 0
    k = pop.cohort_size(fl) if population else fl.n_devices
    ragged = population and fl.cohort_sampler == 'availability'
    byz_cpu, draw_active = _adversary_closures(fl)
    byz_on = {}          # the mask on each device, copied before a capture
    method = fl.allocator
    solve_kw = dict(max_iters=fl.allocation_max_iters or 6,
                    tol=fl.allocation_tol or 1e-5,
                    early_exit=fl.allocation_early_exit)

    def alloc_f32(stats, v, gb2s, gains, p_w):
        """Eq. (28) in float32 on the round's exact stats: per-client g2
        and v, the shared ||ḡ||^2 and the Lemma-2 delta^2."""
        with record_function('round/stats'):
            d2 = tr.delta_sq_tree(stats, fl.quant_bits).to(torch.float32)
            prob = alloc_jax.problem_from_stats(
                stats['g2'], gb2s.expand(k), v, d2, gains, p_w,
                stats['dim'], fl, dtype=torch.float32)
        with record_function('round/solve'):
            return ops.alloc_solve(
                prob, method, gate=None if method == 'uniform' else gb2s,
                **solve_kw)

    def round_fn(params, opt_state, gbar, batch, gains, draws, round_idx,
                 cohort=None, active_u=None):
        dev = batch['tokens'].device
        _check_block(mesh, k, batch['tokens'].shape[0])
        with record_function('round/gradients'):
            losses, grads = client_grads(params, cfg, batch['tokens'],
                                         deterministic,
                                         prefix=batch.get('prefix'))
        if cohort is not None:
            p_w, byz = cohort.p_w, cohort.byzantine
            present = cohort.present if ragged else None
            gains = cohort.gains
        else:
            p_w = torch.full((k,), fl.tx_power_w, dtype=torch.float32,
                             device=dev)
            if byz_cpu is not None and dev not in byz_on:
                byz_on[dev] = byz_cpu.to(dev)
            byz, present = byz_on.get(dev), None
        active = pop.combine_active(present, draw_active(active_u))
        with record_function('round/stats'):
            stats = tr.tree_client_stats(grads)
            more = (exact_v(grads, gbar),) if transport_kind == 'spfl' else ()
            losses, stats, more = _gather_report(mesh, k, losses, stats,
                                                 *more)
        obj = iters = reason = None
        if transport_kind == 'spfl':
            sol = alloc_f32(stats, more[0], gbar_norm_sq(gbar), gains, p_w)
            q, p = sol.q, sol.p
            obj, iters, reason = sol.objective, sol.iters, sol.exit_reason
            with record_function('round/transport'):
                ghat, _, diag = tr.spfl_aggregate_tree(
                    grads, gbar, q, p, fl, draws, stats=stats, mesh=mesh,
                    attack=fl.attack, byz_mask=byz,
                    attack_scale=fl.attack_scale, active=active,
                    screen=fl.screen, screen_z=fl.screen_z,
                    min_participation=fl.min_participation)
        else:
            q = p = torch.ones((k,), dtype=torch.float32, device=dev)
            with record_function('round/transport'):
                ghat, _, diag = tr.error_free_aggregate_tree(
                    grads, fl, draws, stats=stats, mesh=mesh, k=k)
        del grads
        with record_function('round/update'):
            new_params, new_opt = opt.update(ghat, opt_state, params)
            new_gbar = tree.map(torch.abs, ghat)
        rec = diag.with_allocation(q, p, objective=obj, round_idx=round_idx,
                                   iters=iters, exit_reason=reason
                                   ).condensed()
        if cohort is not None:
            rec = rec._replace(cohort_ids=cohort.ids)
        return new_params, new_opt, new_gbar, rec, torch.mean(losses)

    return round_fn


def round_host_inputs(fl: FLConfig, k: int, n_leaves: int, n: int,
                      host_generator: torch.Generator,
                      straggler_generator: Optional[torch.Generator] = None,
                      transport_kind: str = 'spfl',
                      gains: Optional[Tensor] = None,
                      cohort: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """A fused round's host-made inputs, CPU tensors by field: the round
    index ``n``, the tree transport's host draws
    (``transport.tree_host_draws`` from ``host_generator``), the
    straggler uniforms (K from ``straggler_generator``, when
    ``fl.dropout_rate > 0``), the round's ``gains`` row and the cohort's
    columns (``population.cohort_columns``), in the host loop's order."""
    out = {'n': torch.tensor([n], dtype=torch.int64)}
    out.update(tr.tree_host_draws(k, n_leaves, 0, fl.channel, host_generator,
                                  kind=transport_kind))
    if fl.dropout_rate > 0.0:
        out['straggler_u'] = torch.rand((k,), generator=straggler_generator)
    if gains is not None:
        out['gains'] = torch.as_tensor(gains, dtype=torch.float64)
    if cohort is not None:
        out['cohort'] = cohort
    return out


def leaf_views(flat: Tensor, k: int, sizes: Sequence[int]) -> List[Tensor]:
    """(K, n_i) views of one round's quantizer uniforms, leaf by leaf,
    over a flat (K * sum n_i,) buffer."""
    out, off = [], 0
    for n in sizes:
        out.append(flat[off:off + k * n].view(k, n))
        off += k * n
    return out


def make_fused_fl_scan(cfg: ModelConfig, fl: FLConfig, base_gains,
                       batch_fn: Callable, optimizer: Optional[Optimizer]
                       = None, transport_kind: str = 'spfl', mesh=None,
                       deterministic: bool = True):
    """Roll :func:`make_fused_fl_round` over whole segments: on the card a
    segment is a CUDA graph ('scan': the segment's rounds in one graph,
    one a segment length; 'eager', ``fl.round_fusion``: one round's graph
    replayed once a round), with no host read or copy between a
    segment's boundaries; on the CPU the same body runs eagerly.

    ``batch_fn(n, shards) -> batch`` makes a round's batch with device
    operations only: ``n`` the round index (an int64 (1,) device tensor),
    ``shards`` None or, in population mode, this rank's cohort slots'
    data shards (``population.shard_ids``).  ``base_gains`` (K,) are the
    static gains of a round whose slot brings none (unused in population
    mode).

    Returns ``(segment, init_carry)``:

    * ``init_carry(params, seg_len)`` -> the carry: the parameters (its
      tensors updated in place), the optimizer state, ḡ, the telemetry
      ring (one slot a round of a segment), the staging of ``seg_len``
      rounds' inputs (``training.fused.Staging``: their host-made inputs
      in one copy, and the (seg_len, K * dim) float32 quantizer uniforms,
      K * dim * 4 bytes a round), and the graphs, captured at first use.
      ``carry.guard`` (a context-manager factory) wraps the first
      segment's warm-up round (run eagerly, before any capture) and each
      segment's upload and launch.
    * ``segment(carry, slots, generator)`` runs ``len(slots)`` rounds:
      slot i holds round i's host-made inputs (:func:`round_host_inputs`);
      each round's uniforms are drawn here from ``generator`` on the
      device, leaf by leaf in ``tree.leaves`` order (the host loop's
      order).  -> the rounds' mean losses, a (m,) device view;
      ``carry.ring`` holds their records.  Under 'sharded', a graph needs
      a group whose collectives it can capture (NCCL, or one rank with no
      group): on the card any other raises ``ValueError``.
    """
    if fl.round_fusion not in ('eager', 'scan'):
        raise ValueError(f'round_fusion must be eager|scan for a fused '
                         f'segment, got {fl.round_fusion!r}')
    opt = optimizer if optimizer is not None else sgd(fl.learning_rate)
    round_fn = make_fused_fl_round(cfg, fl, opt, transport_kind, mesh,
                                   deterministic)
    population = fl.population_n > 0
    k = pop.cohort_size(fl) if population else fl.n_devices
    mesh = _step_mesh(fl, mesh, 'make_fused_fl_scan')
    rows = mesh.rows(k)
    allocating = transport_kind == 'spfl'

    def one_round(carry, inp, rand):
        cohort = (pop.cohort_round(inp['cohort'], fl, allocating)
                  if population else None)
        gains = inp.get('gains', carry.gains)
        if gains is None and allocating and not population:
            raise ValueError('the round needs its gains: give base_gains '
                             "or a 'gains' field in its slot")
        draws = tr.TreeDraws(leaf_views(rand, k, carry.sizes),
                             **{f: inp[f] for f in ('seeds', 'sign_u',
                                                    'mod_u') if f in inp})
        batch = batch_fn(inp['n'], None if cohort is None
                         else cohort.shards[rows])
        params, opt_state, gbar, rec, loss = round_fn(
            carry.params, carry.opt_state, carry.gbar, batch,
            gains, draws, inp['n'][0],
            cohort, inp.get('straggler_u'))
        # the carry, in place: a graph reads and writes it at its address
        for dst, src in zip(tree.leaves(carry.params), tree.leaves(params)):
            dst.copy_(src)
        for dst, src in zip(tree.leaves(carry.opt_state),
                            tree.leaves(opt_state)):
            dst.copy_(src)
        for dst, src in zip(tree.leaves(carry.gbar), tree.leaves(gbar)):
            dst.copy_(src)
        return rec, loss

    def init_carry(params, seg_len: int):
        first = tree.leaves(params)[0]
        dev = first.device
        sizes = [int(x.numel()) for x in tree.leaves(params)]
        if dev.type == 'cuda' and not mesh.capturable:
            raise ValueError(
                f"fused rounds with collective='sharded' on the card need "
                f'a process group whose collectives a CUDA graph can '
                f'capture (NCCL), got {mesh.backend!r}: a {mesh.backend} '
                'collective goes through the host')
        return SimpleNamespace(
            device=dev, sizes=sizes, seg_len=seg_len,
            params=params, opt_state=opt.init(params),
            gbar=init_gbar(params),
            gains=(None if base_gains is None
                   else torch.as_tensor(base_gains, dtype=torch.float64,
                                        device=dev)),
            stage=None, static=None, ring=None, out_ring=None,
            losses=torch.zeros((seg_len,), device=dev),
            static_loss=torch.zeros((), device=dev),
            stream=fused.side_stream(dev), graphs={},
            guard=contextlib.nullcontext, capture_s=0.0)

    def warm_up(carry):
        """One round on scratch copies of the carry, on the capture
        stream, before anything is captured (kernels loaded, cuBLAS and
        the vmapped gradient initialised) -> its record (the ring's
        prototype)."""
        kept = (carry.params, carry.opt_state, carry.gbar)
        carry.params = tree.map(torch.clone, carry.params)
        carry.opt_state = tree.map(torch.clone, carry.opt_state)
        carry.gbar = tree.map(torch.clone, carry.gbar)
        try:
            with fused.on_stream(carry.stream):
                rec, _ = one_round(carry, *carry.stage.slot(0))
        finally:
            carry.params, carry.opt_state, carry.gbar = kept
        return rec

    def launcher(carry, m: int):
        on_card = carry.device.type == 'cuda'
        stage = carry.stage

        def scan_rounds():
            for i in range(m):
                rec, loss = one_round(carry, *stage.slot(i))
                obs_ring.ring_write(carry.ring, i, rec)
                carry.losses[i].copy_(loss)

        def eager_round():
            rec, loss = one_round(carry, *carry.static.slot(0))
            obs_ring.ring_write(carry.out_ring, 0, rec)
            carry.static_loss.copy_(loss)

        eager = fl.round_fusion == 'eager'
        key = 'eager' if eager else m
        body = eager_round if eager else scan_rounds
        if on_card and key not in carry.graphs:
            t0 = time.perf_counter()
            carry.graphs[key] = fused.capture(body, carry.stream)
            carry.capture_s += time.perf_counter() - t0
        step = carry.graphs[key].replay if on_card else body
        if not eager:
            return step

        def rounds():
            for i in range(m):
                carry.static.dev[0].copy_(stage.dev[i])
                carry.static.rand[0].copy_(stage.rand[i])
                step()
                obs_ring.ring_copy(carry.ring, i, carry.out_ring, 0)
                carry.losses[i].copy_(carry.static_loss)
        return rounds

    def segment(carry, slots: Sequence[Dict[str, Tensor]],
                generator: torch.Generator) -> Tensor:
        m = len(slots)
        if not 1 <= m <= carry.seg_len:
            raise ValueError(f'a segment of {m} rounds; the carry holds '
                             f'{carry.seg_len}')
        if carry.stage is None:
            layout = fused.SlotLayout(slots[0])
            rand_shape = (k * sum(carry.sizes),)
            carry.stage = fused.Staging(layout, carry.seg_len, rand_shape,
                                        carry.device)
            if fl.round_fusion == 'eager':
                carry.static = fused.Staging(layout, 1, rand_shape,
                                             carry.device)
        for i, values in enumerate(slots):
            carry.stage.put(i, values)
            for view in leaf_views(carry.stage.rand[i], k, carry.sizes):
                view.uniform_(0.0, 1.0, generator=generator)
        if carry.ring is None:
            carry.stage.upload(m)
            with carry.guard():
                proto = warm_up(carry)
            carry.ring = obs_ring.ring_init(proto, carry.seg_len)
            if fl.round_fusion == 'eager':
                carry.out_ring = obs_ring.ring_init(proto, 1)
        launch = launcher(carry, m)
        with carry.guard():
            carry.stage.upload(m)             # the segment's one copy
            launch()
        obs_ring.ring_written(carry.ring, m)
        return carry.losses[:m]

    return segment, init_carry


def make_standard_train_step(cfg: ModelConfig, fl: FLConfig, mesh=None):
    """Plain data-parallel step (batch (B, T), one global gradient, the
    update of :func:`make_fl_train_step` without a transport): returns
    ``train_step(params, batch) -> (new_params, {'loss', 'g_norm_sq'})``:
    ``batch`` holds (B, T) ``tokens`` [and a (B, P, E) ``prefix``].  The
    reference uses it where per-client gradients do not exist at scale
    (arctic-480b's experts sharded over the client axes).  On a
    production mesh (``mesh``) it is ``training.model_axis``'s: the
    parameters are the rank's blocks, ``batch`` the rank's rows."""
    if mesh is not None:
        from repro_torch.training import model_axis
        return model_axis.make_standard_train_step(cfg, fl, mesh)
    lr = fl.learning_rate

    def train_step(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        loss = tf.loss_fn(tree.unflatten(params, leaves), cfg,
                          batch['tokens'], batch.get('prefix'))
        grads = torch.autograd.grad(loss, leaves)
        new_params = tree.unflatten(params, [
            (p.detach().to(torch.float32) - lr * g.to(torch.float32)
             ).to(p.dtype) for p, g in zip(leaves, grads)])
        g2 = sum(torch.sum(torch.square(g.to(torch.float32)))
                 for g in grads)
        return new_params, {'loss': loss.detach(), 'g_norm_sq': g2}

    return train_step


def make_eval_step(cfg: ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            return tf.loss_fn(params, cfg, batch['tokens'],
                              batch.get('prefix'))
    return eval_step
