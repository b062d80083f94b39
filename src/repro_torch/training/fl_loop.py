"""Paper-scale wireless FL simulator — Algorithm 2 in a host loop, or in
fused rounds (the port of ``repro.training.fl_loop``).

Per round n:
  1. each device computes g_{k,n} = ∇F_k(w_n): one batched
     ``torch.func.vmap`` of the gradient over the K clients, taken with
     respect to the flat reference-order parameter vector;
  2. for spfl/spfl_retx the PS solves eq. (28) -> (q, p): on the host in
     float64 NumPy (``core.allocation``, ``allocation_backend='numpy'``),
     or on the device (``core.allocation_jax``,
     ``allocation_backend='jax'``: the per-client scalars are reduced on
     the card and one ``alloc_solve`` launch solves, with no
     device-to-host copy before the transport).  The gains are the static
     geometry's, or under ``allocation_cadence='per_round'`` that round's
     row of a block-fading trajectory (``channel.block_fading_trajectory``,
     built on the host once a run, one float64 copy on the device).  The
     baselines solve nothing: q = p = 1;
  3. the uplink runs through the transport (``core.transport``: spfl on
     the packed, bit-level wire runs the four round kernels, error_free on
     the packed wire quantize_pack and spfl_accumulate; dds, onebit and
     scheduling see the static gains and, but scheduling, beta = 1/K);
  4. SGD update w <- w - eta ghat, and the compensation state rolls
     (``core.compensation``).

The adversarial knobs (``adversary``): ``attack`` in {signflip, scaled,
labelflip} with a byzantine fraction ``attack_frac``, ``screen`` (the
packed-domain defense) and ``dropout_rate > 0`` (the Gilbert straggler
chain, ``straggler_stickiness``) reach spfl/spfl_retx; labelflip poisons
the byzantine rows' labels at set-up for every transport.

Population mode (``population_n > 0``, ``population``): the round's K
clients are a cohort sampled from N registered devices, and the data
holds ``population_shards`` shards, device d reading shard d mod S.
Every round runs ``self.key, kr = threefry.split(self.key)`` from
``threefry.key(seed)``, as the reference's loop does, and draws the
cohort (ids, presence, power budgets, byzantine membership, gains) from
``kr`` and the population key: bit for bit the reference's cohort, round
for round.  The draw is O(K) bookkeeping with no input from the card:
it runs on CPU tensors on the host (span ``round/cohort``) and the
cohort's per-slot arrays reach the card in one copy, as the straggler
uniforms and the fading trajectory do; the shard images are gathered on
the card.

Telemetry (``obs``): each round's record, condensed (the vote vector
reduced to its agreement on the device), is pushed into a device ring
(``obs.ringbuf``) with device copies only; every
``telemetry_flush_every`` rounds and after the last the ring comes to
the host in one copy, and its rows (``obs.record.to_row``) fill the
``FLHistory`` lists and ``sim.records``, feed ``sim.metrics`` and, with
``telemetry_path`` set, the JSONL sink (``obs.sink``), which also gets
the host spans of ``sim.trace`` and the metrics at the end of the run.

Fused rounds (``round_fusion`` 'eager' or 'scan', :meth:`FLSimulator.
_run_fused`, ``training.fused``): the rounds run in segments of
``scan_segment_rounds`` (default ``telemetry_flush_every``) with no host
read or host copy inside a segment.  Every draw the host loop makes on
the host is made at the segment's boundary, from the same generators in
the same order, and reaches the card in one copy a segment; eq. (28) is
solved in float32 inside the round (the reference's ``alloc_f32``: f32
stats, ``problem_from_stats(dtype=float32)``, the ``alloc_solve_f32``
kernel, the round-0 guard as the kernel's gate).  On the card 'scan'
captures a segment's rounds into one CUDA graph and launches it once a
segment, 'eager' captures one round and replays it once a round; on the
CPU both run the same round body eagerly.  The host loop and the fused
rounds share one round body (:meth:`FLSimulator._round_body`), which
updates the simulator's carry (``sim.params``, ``sim.gbar``, the
straggler state) in place; the fused runs keep their buffers and graphs
from one run to the next.  A transport that solves
nothing gives the host loop's run bit for bit; spfl/spfl_retx differ
from it only through the float32 solve's (q, p).  The boundary is the
run's only sync point: one ring flush, the evaluation (every boundary;
``eval_every`` is quantized to them) and the segment's last mean client
loss; ``alloc_time_s`` is 0.0 and ``round_time_s`` the segment's wall
time over its rounds.

The CNN runs in full float32: constructing a simulator sets
``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False`` (process-wide), since
TF32 convolutions keep about three decimal digits.  The gradient pass
runs under ``torch.backends.cudnn.deterministic`` when
``sim.deterministic`` is set (the default under fused rounds, so that a
round gives the same bits whether it runs eagerly or replays from a
graph, and 'scan' the same as 'eager'): cuDNN's default weight-gradient
algorithm on the card adds in an order that changes from pass to pass.
The host loop does not set it by default (the deterministic algorithms
are slower; PERF.md has the cost) and leaves the process-wide flag as
the caller set it; set ``sim.deterministic = True`` to compare a
host-loop run with a fused one bit for bit on the card.

Randomness comes from ``torch.Generator``s seeded from the run seed
(and, in population mode, from the Threefry keys above):
one on the device for the (K, l) quantizer uniforms, one on the host for
the geometry, the initial weights, the bit-channel seed words, the
Bernoulli and packet-fate uniforms and scheduling's Rayleigh draws, and
one on the host, seeded anew by every ``run`` from the seed plus
``FADING_SEED_OFFSET``, for the standard normals of the fading
trajectory; and, only when their knobs are on, one seeded with the
seed plus ``adversary.BYZ_FOLD`` for the byzantine permutation (at
set-up) and one with the seed plus ``adversary.STRAGGLER_FOLD`` for the K
uniforms of each round's straggler step (taken before the gradients).
The draws differ from the reference's ``jax.random``
streams, so whole-run agreement with the reference is statistical; one
round given the same draws (and gains) agrees exactly
(``tests/test_torch_slice.py``, ``tests/test_torch_slice_fading.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap
from torch.profiler import record_function

from repro_torch import adversary
from repro_torch import population as pop
from repro_torch.configs.base import FLConfig
from repro_torch.core import allocation as alloc
from repro_torch.core import allocation_jax as alloc_jax
from repro_torch.core import channel, compensation, convergence, transport
from repro_torch.core import threefry
from repro_torch.core.quantize import expected_quant_mse
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import ops
from repro_torch.models.cnn import (
    CNN, cnn_accuracy, cnn_loss, init_params, module_params,
)
from repro_torch.obs import ringbuf as obs_ring
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.record import RoundTelemetry, to_row
from repro_torch.obs.sink import JsonlSink, run_manifest
from repro_torch.obs.trace import StageTrace
from repro_torch.training import fused


ALLOCATION_BACKENDS = ('numpy', 'jax')
CADENCES = ('static', 'per_round')
ALLOCATING = ('spfl', 'spfl_retx')       # the transports that solve eq. (28)
# the fading trajectory's normals come from a host generator seeded with
# the run seed plus this offset (the reference folds 0x0FAD into its key)
FADING_SEED_OFFSET = 0x0FAD


def check_supported(fl: FLConfig) -> None:
    """Raise on configurations the reference refuses (the port runs every
    knob the reference's loop does; like the reference's, the loop never
    reads ``collective``)."""
    if fl.transport not in transport.KINDS:
        raise ValueError(f'transport must be one of {transport.KINDS}')
    if fl.attack not in adversary.ATTACK_KINDS:
        raise ValueError(f'attack must be one of {adversary.ATTACK_KINDS}')
    if fl.allocation_backend not in ALLOCATION_BACKENDS:
        raise ValueError(f'allocation_backend must be one of '
                         f'{ALLOCATION_BACKENDS}')
    if fl.allocation_cadence not in CADENCES:
        raise ValueError(f'allocation_cadence must be one of {CADENCES}')
    if fl.compensation not in compensation.KINDS:
        raise ValueError(f'compensation must be one of {compensation.KINDS}')
    if fl.wire not in transport.WIRE_KINDS:
        raise ValueError(f'wire must be one of {transport.WIRE_KINDS}')
    if fl.channel not in channel.CHANNEL_KINDS:
        raise ValueError(f'channel must be one of {channel.CHANNEL_KINDS}')
    if (fl.channel == 'bitlevel' and fl.wire != 'packed'
            and fl.transport in ALLOCATING):
        # the single-packet baselines keep their buffers analytic and
        # take the bit channel's calibration only
        raise ValueError("channel='bitlevel' requires wire='packed'")
    if fl.population_n > 0:
        _check_population(fl)


def _check_population(fl: FLConfig) -> None:
    """The reference's guard rails of population mode, with its
    messages."""
    pop.validate(fl)
    if fl.transport not in ('spfl', 'spfl_retx', 'error_free'):
        raise ValueError(
            'population mode is defined for the spfl/spfl_retx/'
            'error_free transports (the analytic baselines pin '
            f'static geometry), got {fl.transport!r}')
    if (fl.cohort_sampler == 'availability'
            and fl.transport == 'error_free'):
        raise ValueError(
            "cohort_sampler='availability' produces ragged "
            'cohorts, which ride the spfl zero-weight padding — '
            'the error_free transport has no active mask')
    if fl.transport in ALLOCATING and fl.allocation_backend != 'jax':
        raise ValueError(
            "population mode requires allocation_backend='jax' "
            'on allocating transports — eq. (28) must re-solve '
            'per sampled cohort on-device')
    if fl.compensation == 'last_local':
        raise ValueError(
            "compensation='last_local' is undefined under "
            'partial participation: cohort slots have no stable '
            'device identity across rounds')
    if fl.attack == 'labelflip':
        raise ValueError(
            "attack='labelflip' is undefined in population mode:"
            ' data shards are shared across virtual devices, so '
            'poisoning a shard is not poisoning a device')


@dataclass
class FLHistory:
    loss: List[float] = field(default_factory=list)
    test_acc: List[float] = field(default_factory=list)
    bound: List[float] = field(default_factory=list)          # per-round RHS
    loss_delta: List[float] = field(default_factory=list)     # measured drop
    payload_bits: List[float] = field(default_factory=list)
    sign_ok_frac: List[float] = field(default_factory=list)
    mod_ok_frac: List[float] = field(default_factory=list)
    q_mean: List[float] = field(default_factory=list)         # mean sign succ
    p_mean: List[float] = field(default_factory=list)         # mean mod succ
    sign_agreement: List[float] = field(default_factory=list)  # packed wire
    alloc_iters: List[float] = field(default_factory=list)
    alloc_exit_reason: List[float] = field(default_factory=list)
    retransmissions: List[float] = field(default_factory=list)
    # the adversarial knobs: the fraction of clients active (appended
    # when dropout_rate > 0) and screened out (when screen); NaN on a
    # round whose transport reports neither (the baselines)
    participation_frac: List[float] = field(default_factory=list)
    suspect_frac: List[float] = field(default_factory=list)
    # host time of step 2: on allocation_backend='numpy' the whole
    # eq. (28) solve; on 'jax' only the cost of queueing it (the solve
    # runs on the card behind the gradients)
    alloc_time_s: List[float] = field(default_factory=list)
    round_time_s: List[float] = field(default_factory=list)

    def as_dict(self) -> Dict[str, List[float]]:
        return dataclasses.asdict(self)


class RoundResult(NamedTuple):
    """Everything one round produced (for callers that inspect a round)."""
    losses: torch.Tensor          # (K,) client losses at w_n
    grads: torch.Tensor           # (K, l) client gradients
    ghat: torch.Tensor            # (l,) aggregate
    telemetry: RoundTelemetry
    allocation: object            # alloc.Allocation (host, 'numpy') or
    #                               alloc_jax.JaxAllocation (card, 'jax');
    #                               None for the baselines
    stats: Optional[dict]         # g2, gb2, v, d2, prob of the solve (and
    #                               on 'numpy' the host grads/gbar)
    alloc_time_s: float


CohortRound = pop.CohortRound


class FLSimulator:
    """K-device wireless FL over the paper's CNN (host loop)."""

    def __init__(self, fl: FLConfig, client_x: np.ndarray,
                 client_y: np.ndarray, test_x: np.ndarray,
                 test_y: np.ndarray, seed: Optional[int] = None,
                 device: DeviceLike = None):
        check_supported(fl)
        self.device = resolve(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # deterministic cuDNN algorithms for the gradient pass
        self.deterministic = fl.round_fusion != 'none'
        self.fl = fl
        seed = fl.seed if seed is None else seed
        # population mode: client_x holds the S data shards and K is the
        # cohort width; per-device state comes from the population key
        self.population = fl.population_n > 0
        if self.population:
            self.K = pop.cohort_size(fl)
            self.pop_key = pop.population_key(seed)
            self.pop_streams = pop.stream_keys(self.pop_key)
        else:
            self.K = client_x.shape[0]
            if self.K != fl.n_devices:
                raise ValueError(f'{self.K} client datasets for n_devices='
                                 f'{fl.n_devices}')
        # the round-key chain of population rounds (the reference's key)
        self.key = threefry.key(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.host_gen = torch.Generator().manual_seed(seed)
        self.model = CNN().to(self.device)
        self._params = init_params(self.host_gen).to(self.device)
        self.dim = self._params.shape[0]

        def to_nchw(x: np.ndarray) -> torch.Tensor:
            t = torch.as_tensor(np.asarray(x, np.float32))
            return t.movedim(-1, -3).contiguous().to(self.device)

        self.client_x = to_nchw(client_x)                  # (K, B, 3, 32, 32)
        self.client_y = torch.as_tensor(np.asarray(client_y, np.int64),
                                        device=self.device)
        # adversarial cohort: membership fixed at set-up by a permutation
        # from its own host generator; labelflip poisons the byzantine
        # rows' labels here too (population mode draws it per id)
        self.byz_mask = None
        if fl.attack != 'none' and not self.population:
            perm = torch.randperm(self.K, generator=torch.Generator()
                                  .manual_seed(seed + adversary.BYZ_FOLD))
            self.byz_mask = adversary.byzantine_mask(
                self.K, fl.attack_frac, perm).to(self.device)
        if fl.attack == 'labelflip':
            n_classes = int(np.max(np.asarray(client_y))) + 1
            self.client_y = adversary.flip_labels(self.client_y,
                                                  self.byz_mask, n_classes)
        # the straggler chain (True = active), stepped once a round on K
        # uniforms from its own host generator (dropout_rate > 0 only)
        self.straggler = adversary.straggler_init(self.K, self.device)
        self.straggler_gen = torch.Generator().manual_seed(
            seed + adversary.STRAGGLER_FOLD)
        self.test_x = to_nchw(test_x)
        self.test_y = torch.as_tensor(np.asarray(test_y, np.int64),
                                      device=self.device)
        self.seed = seed
        # host-side eq. (28) solves performed (0 on the 'jax' backend)
        self.host_solver_calls = 0
        if self.population:
            # per-cohort gains and budgets come from the population key;
            # these placeholders only size the unused static channel
            self.gains = np.ones(self.K)
        else:
            # static wireless geometry (paper: uniform in a 500 m annulus)
            dist = channel.sample_distances(self.host_gen, self.K,
                                            fl.cell_radius_m)
            self.gains = channel.path_gain(dist, fl.path_loss_exp)
        self.p_w = np.full(self.K, fl.tx_power_w)
        # the same gains and budgets in float64 on the device, for the
        # on-device solver; its budgets rounded to float32 first, as the
        # reference's on-device path builds them
        self.gains_dev = torch.as_tensor(np.asarray(self.gains, np.float64),
                                         device=self.device)
        self.p_w_dev = torch.as_tensor(
            self.p_w.astype(np.float32).astype(np.float64),
            device=self.device)
        # the baselines' channel, float32 as the reference's closures hold
        # it: static gains, budgets and the uniform band share
        self.gains_f32 = torch.as_tensor(self.gains, dtype=torch.float32,
                                         device=self.device)
        self.p_w_f32 = torch.as_tensor(self.p_w, dtype=torch.float32,
                                       device=self.device)
        self.beta_uniform = torch.full((self.K,), 1.0 / self.K,
                                       dtype=torch.float32,
                                       device=self.device)
        self.comp = compensation.init_state(
            fl.compensation, torch.zeros(self.dim, device=self.device),
            self.K)
        # the current run's fading gains (n_rounds, K), float64 on the
        # device (allocation_cadence='per_round'; None before a run)
        self.trajectory: Optional[torch.Tensor] = None
        self._round = 0
        # host copies of every round's condensed telemetry, filled at
        # each flush of the ring
        self.records: List[RoundTelemetry] = []
        # host spans (alloc_solve, update) and the metrics channels fed
        # from the flushed rows
        self.trace = StageTrace()
        self.metrics = MetricsRegistry()
        # fused rounds: a context manager entered around each segment's
        # launch (its upload and replays), for callers that watch it
        # (a sync-debug mode on the card, host reads made to raise)
        self.segment_guard = contextlib.nullcontext
        # fused rounds: the buffers and graphs kept from run to run
        # (``_fused_setup``; None before the first fused run)
        self._fused = None

        def client_loss(flat, x, y):
            logits = functional_call(self.model, module_params(flat), (x,))
            return cnn_loss(logits, y)

        self._client_grads = vmap(grad_and_value(client_loss),
                                  in_dims=(None, 0, 0))

    # ------------------------------------------------------------------
    @property
    def params(self) -> torch.Tensor:
        """The flat model parameters.  The simulator owns the tensor and
        every round updates it in place (a captured round writes to its
        address); assigning copies the value into it."""
        return self._params

    @params.setter
    def params(self, value: torch.Tensor) -> None:
        self._params.copy_(value)

    @property
    def gbar(self) -> torch.Tensor:
        """The compensation vector(s) the next round uses (owned and
        updated in place, as :attr:`params`)."""
        return self.comp.gbar

    @gbar.setter
    def gbar(self, value: torch.Tensor) -> None:
        self.comp.gbar.copy_(value)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.model, module_params(self.params), (x,))

    def client_grads(self, params: torch.Tensor,
                     cohort: Optional[CohortRound] = None):
        """-> (losses (K,), grads (K, l)) at ``params`` on the clients'
        data, or on ``cohort``'s shards (population mode)."""
        xs, ys = self.client_x, self.client_y
        if cohort is not None:
            xs = xs.index_select(0, cohort.shards)
            ys = ys.index_select(0, cohort.shards)
        with (_cudnn_deterministic() if self.deterministic
              else contextlib.nullcontext()):
            grads, losses = self._client_grads(params, xs, ys)
        return losses, grads

    @torch.no_grad()
    def global_metrics(self):
        """(mean client training loss, test accuracy) at the current w."""
        k, b = self.client_y.shape
        logits = self.logits(self.client_x.reshape(k * b, 3, 32, 32))
        logits = logits.reshape(k, b, -1)
        loss = torch.stack([cnn_loss(logits[i], self.client_y[i])
                            for i in range(k)]).mean()
        acc = cnn_accuracy(self.logits, self.test_x, self.test_y)
        return float(loss), float(acc)

    def allocate(self, grads: torch.Tensor, gbar: torch.Tensor,
                 gains: Optional[np.ndarray] = None):
        """Steps 3-4: the per-client scalars go to the host and the PS
        solves eq. (28) in float64 NumPy -> (Allocation, stats).
        ``gains`` (K,) default to the static geometry's."""
        fl = self.fl
        self.host_solver_calls += 1
        gains = self.gains if gains is None else np.asarray(gains,
                                                           np.float64)
        grads_np = grads.detach().to('cpu', torch.float64).numpy()
        gbar_np = gbar.detach().cpu().numpy()
        g2 = np.sum(grads_np ** 2, axis=1)
        gb = gbar_np if gbar_np.ndim == 2 else np.broadcast_to(
            gbar_np, grads_np.shape)
        gb2 = np.sum(gb ** 2, axis=1)
        v = np.sum(np.abs(grads_np) * gb, axis=1)
        # exact expected quantization MSE, f32 on the device
        d2 = expected_quant_mse(grads.detach(), fl.quant_bits,
                                dim=1).cpu().numpy()
        prob = alloc.problem_from_stats(g2, gb2, v, d2, gains, self.p_w,
                                        self.dim, fl)
        method = fl.allocator
        if float(gb2.max()) == 0.0:
            # no compensation history yet (round 0): optimizing against
            # gbar=0 degenerates to alpha=1 / ghat=0; use uniform
            method = 'uniform'
        if method == 'alternating':
            sol = alloc.solve(prob, 'alternating',
                              max_iters=fl.allocation_max_iters or 2)
        elif method == 'barrier':
            sol = alloc.solve(prob, 'barrier',
                              max_iters=fl.allocation_max_iters or 6)
        else:
            sol = alloc.solve(prob, 'uniform')
        return sol, dict(g2=g2, gb2=gb2, v=v, d2=d2, prob=prob,
                         grads=grads_np, gbar=gbar_np)

    def allocate_on_device(self, grads: torch.Tensor, gbar: torch.Tensor,
                           gains: Optional[torch.Tensor] = None,
                           p_w: Optional[torch.Tensor] = None):
        """Steps 3-4 on the device: the per-client scalars reduced in
        float64 where the gradients lie, and one solver call (one kernel
        launch on the card) -> (JaxAllocation, stats).  Nothing is read
        back to the host; the round-0 guard (no compensation history) is
        the solver's gate, max(gb2) > 0.  ``gains`` and ``p_w`` (K,)
        float64 on the device default to the static geometry's and the
        float32-rounded budgets."""
        fl = self.fl
        gains = self.gains_dev if gains is None else gains
        p_w = self.p_w_dev if p_w is None else p_w
        with record_function('round/stats'):
            g64 = grads.detach().to(torch.float64)
            gb = gbar if gbar.dim() == 2 else gbar.expand(grads.shape)
            gb64 = gb.detach().to(torch.float64)
            g2 = torch.sum(g64 ** 2, dim=1)
            gb2 = torch.sum(gb64 ** 2, dim=1)
            v = torch.sum(torch.abs(g64) * gb64, dim=1)
            d2 = expected_quant_mse(grads.detach(), fl.quant_bits,
                                    dim=1).to(torch.float64)
            prob = alloc_jax.problem_from_stats(g2, gb2, v, d2, gains,
                                                p_w, self.dim, fl)
        method = fl.allocator
        with record_function('round/solve'):
            gate = None if method == 'uniform' else torch.amax(gb2)
            sol = ops.alloc_solve(prob, method,
                                  max_iters=fl.allocation_max_iters or 6,
                                  tol=fl.allocation_tol or 1e-5,
                                  early_exit=fl.allocation_early_exit,
                                  gate=gate)
        return sol, dict(g2=g2, gb2=gb2, v=v, d2=d2, prob=prob)

    def draw(self) -> transport.Draws:
        """One round's transport draws from the simulator's generators."""
        fl = self.fl
        n_retx = 1 if fl.transport == 'spfl_retx' else 0
        return transport.make_draws(self.K, self.dim, n_retx, fl.channel,
                                    self.device, self.gen, self.host_gen,
                                    kind=fl.transport)

    def fading_trajectory(self, n_rounds: int) -> torch.Tensor:
        """The run's block-fading gains (n_rounds, K), float32 on the host:
        standard normals from a host generator seeded with the run seed
        plus ``FADING_SEED_OFFSET`` (the same trajectory for every run of
        this simulator), over the float32 static gains."""
        gen = torch.Generator().manual_seed(self.seed + FADING_SEED_OFFSET)
        eps = torch.randn((n_rounds, self.K), generator=gen)
        return channel.block_fading_trajectory(
            eps, torch.as_tensor(self.gains, dtype=torch.float32))

    def _solve(self, grads: torch.Tensor, gains, p_w=None):
        """Step 2 of an allocating transport -> (sol, stats, q, p,
        objective, iters, exit_reason, host seconds)."""
        fl = self.fl
        ta = time.perf_counter()
        if fl.allocation_backend == 'jax':
            if gains is not None:
                gains = torch.as_tensor(gains, dtype=torch.float64,
                                        device=self.device)
            # a cohort's budgets only where there is one (wrappers of
            # allocate_on_device take its first three arguments)
            extra = () if p_w is None else (p_w,)
            sol, stats = self.allocate_on_device(grads, self.gbar, gains,
                                                 *extra)
            alloc_t = time.perf_counter() - ta
            return (sol, stats, sol.q.to(torch.float32),
                    sol.p.to(torch.float32), sol.objective, sol.iters,
                    sol.exit_reason, alloc_t)
        if isinstance(gains, torch.Tensor):
            gains = gains.cpu().numpy()
        sol, stats = self.allocate(grads, self.gbar, gains)
        alloc_t = time.perf_counter() - ta
        objs = sol.info.get('objectives', [])
        if len(objs) >= 2:
            self.metrics.observe_alloc(outer_residual=abs(objs[-1]
                                                          - objs[-2]))
        q = torch.as_tensor(sol.q, dtype=torch.float32, device=self.device)
        p = torch.as_tensor(sol.p, dtype=torch.float32, device=self.device)
        return (sol, stats, q, p, sol.objective,
                int(sol.info.get('iters_used', 0)),
                int(sol.info.get('exit_reason', 0)), alloc_t)

    def draw_cohort(self, round_key: Optional[torch.Tensor] = None,
                    n: Optional[int] = None) -> pop.CohortDraw:
        """Population mode: the cohort of round key ``round_key`` (default:
        the next key of the chain, ``self.key, kr = split(self.key)``), its
        gains at round ``n`` (default this round; shadowed under
        ``allocation_cadence='per_round'``) and, under an attack, its
        byzantine membership — CPU tensors (``population.draw_cohort``)."""
        fl = self.fl
        if round_key is None:
            self.key, round_key = threefry.split(self.key)
        return pop.draw_cohort(
            round_key, self.pop_streams, fl,
            self._round if n is None else n,
            gains=fl.transport in ALLOCATING,
            shadowing=fl.allocation_cadence == 'per_round',
            byzantine=fl.attack != 'none')

    def cohort_to_device(self, draw: pop.CohortDraw) -> CohortRound:
        """A host cohort draw on the simulator's device, in one copy of
        its :meth:`cohort_columns`, split there (:meth:`cohort_round`)."""
        return self.cohort_round(self.cohort_columns(draw).to(
            self.device, non_blocking=True))

    def cohort_columns(self, draw: pop.CohortDraw) -> torch.Tensor:
        """A host cohort draw's per-slot arrays as (K, C) float64 columns
        on the host (``population.cohort_columns``)."""
        return pop.cohort_columns(draw, self.client_x.shape[0])

    def cohort_round(self, cols: torch.Tensor) -> CohortRound:
        """The :class:`CohortRound` of (K, C) :meth:`cohort_columns` on the
        device (device operations only)."""
        return pop.cohort_round(cols, self.fl,
                                self.fl.transport in ALLOCATING)

    def step_stragglers(self, u: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """One step of the straggler chain on the (K,) f32 uniforms ``u``
        (default: K fresh ones from ``straggler_gen``), its state updated
        in place -> this round's (K,) bool active mask."""
        fl = self.fl
        if u is None:
            u = torch.rand((self.K,), generator=self.straggler_gen)
        state, active = adversary.straggler_step(
            u.to(self.device), self.straggler, fl.dropout_rate,
            fl.straggler_stickiness)
        self.straggler.copy_(state)
        return active

    def _transport(self, grads, q, p, draws, active=None, byz_mask=None,
                   round_idx=None):
        """Step 3: the configured transport -> (ghat, telemetry).  The
        adversarial knobs reach spfl/spfl_retx only; ``byz_mask`` (the
        cohort's, in population mode) replaces the run-static mask;
        ``round_idx`` (an int, or an int64 device scalar in fused rounds;
        default this round) stamps the packet headers."""
        fl, kind = self.fl, self.fl.transport
        round_idx = self._round if round_idx is None else round_idx
        if kind in ALLOCATING:
            return transport.spfl_aggregate(
                grads, self.gbar, q, p, fl.quant_bits, fl.b0_bits, draws,
                n_retx=1 if kind == 'spfl_retx' else 0, wire=fl.wire,
                round_idx=round_idx, channel=fl.channel,
                attack=fl.attack,
                byz_mask=self.byz_mask if byz_mask is None else byz_mask,
                attack_scale=fl.attack_scale, active=active,
                screen=fl.screen, screen_z=fl.screen_z,
                min_participation=fl.min_participation)
        if kind == 'dds':
            return transport.dds_aggregate(grads, self.beta_uniform,
                                           self.gains_f32, self.p_w_f32, fl,
                                           draws)
        if kind == 'onebit':
            return transport.onebit_aggregate(grads, self.beta_uniform,
                                              self.gains_f32, self.p_w_f32,
                                              fl, draws)
        if kind == 'scheduling':
            return transport.scheduling_aggregate(grads, self.gains_f32,
                                                  self.p_w_f32, fl, draws)
        return transport.error_free_aggregate(grads, fl, draws,
                                              round_idx=round_idx)

    def _roll_compensation(self, ghat: torch.Tensor, grads: torch.Tensor,
                           normals: Optional[torch.Tensor]) -> None:
        """Step 4's ḡ roll, in place.  seeded_random takes the next round's
        vector from ``normals`` (:meth:`_host_inputs`)."""
        kind = self.fl.compensation
        state = compensation.update_state(kind, self.comp, ghat, grads)
        gbar = (compensation.current_gbar(kind, state, normals=normals)
                if kind == 'seeded_random' else state.gbar)
        if gbar is not self.comp.gbar:
            self.comp.gbar.copy_(gbar)
        self.comp = self.comp._replace(round_idx=state.round_idx)

    def _host_inputs(self, n_run: int, n: int,
                     cohort: Optional[pop.CohortDraw] = None,
                     straggler_u: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
        """The host-made inputs of the run's round ``n_run`` (round ``n``
        of the simulator) that both dispatches draw the same way, CPU
        tensors by field: the cohort's columns (population mode;
        ``cohort`` or the next of the key chain), the straggler uniforms
        (``straggler_u`` or K from ``straggler_gen``) and the
        seeded-random normals (a generator seeded off the seed and
        ``n_run``)."""
        fl = self.fl
        out = {}
        if self.population:
            with record_function('round/cohort'):
                out['cohort'] = self.cohort_columns(
                    self.draw_cohort(n=n) if cohort is None else cohort)
        if fl.dropout_rate > 0.0:
            out['straggler_u'] = (
                torch.rand((self.K,), generator=self.straggler_gen)
                if straggler_u is None else straggler_u)
        if fl.compensation == 'seeded_random':
            gen = torch.Generator().manual_seed(
                (fl.seed + 99) * 1_000_003 + n_run)
            out['normals'] = torch.randn(self.gbar.shape, generator=gen,
                                         dtype=torch.float32)
        return out

    def _round_body(self, inp: Dict[str, torch.Tensor],
                    draws: transport.Draws, solve, round_idx
                    ) -> RoundResult:
        """One round of Algorithm 2, for both dispatches: the host loop
        (:meth:`round_step`) and the fused rounds (:meth:`_fused_round`).
        ``inp`` holds the round's inputs by field (:meth:`_host_inputs`,
        and ``gains`` where given; the cohort's columns on the device),
        ``solve(grads, gains, p_w)`` is step 2 (:meth:`_solve` or
        :meth:`_solve_f32`), ``round_idx`` stamps the headers and the
        record.  The carry (parameters, ḡ, straggler state) is updated in
        place."""
        fl = self.fl
        crd = self.cohort_round(inp['cohort']) if self.population else None
        gains = crd.gains if crd is not None else inp.get('gains')
        active = (self.step_stragglers(inp['straggler_u'])
                  if fl.dropout_rate > 0.0 else None)
        if crd is not None:
            active = pop.combine_active(crd.present, active)
        with record_function('round/gradients'):
            losses, grads = self.client_grads(self.params, crd)
        with self.trace.span('alloc_solve'):
            if fl.transport in ALLOCATING:
                solved = solve(grads, gains,
                               None if crd is None else crd.p_w)
            else:
                # no eq. (28) solve: q = p = 1, as the reference's loop
                ones = torch.ones(self.K, device=self.device)
                solved = (None, None, ones, ones, None, None, None, 0.0)
        sol, stats, q, p, objective, iters, reason, alloc_t = solved
        with record_function('round/transport'):
            ghat, rec = self._transport(
                grads, q, p, draws, active,
                None if crd is None else crd.byzantine, round_idx=round_idx)
        with self.trace.span('update'), record_function('round/update'):
            self.params.copy_(self.params - fl.learning_rate * ghat)
            self._roll_compensation(ghat, grads, inp.get('normals'))
        rec = rec.with_allocation(q, p, objective=objective,
                                  round_idx=round_idx, iters=iters,
                                  exit_reason=reason)
        if crd is not None:
            rec = rec._replace(cohort_ids=crd.ids)
        return RoundResult(losses, grads, ghat, rec, sol, stats, alloc_t)

    def round_step(self, draws: Optional[transport.Draws] = None,
                   n: Optional[int] = None, gains=None,
                   straggler_u: Optional[torch.Tensor] = None,
                   cohort: Optional[pop.CohortDraw] = None
                   ) -> RoundResult:
        """One round of Algorithm 2 in the host loop; ``draws`` default to
        fresh ones from the simulator's generators.  ``n`` is the index
        within the current ``run`` (the seeded-random compensation keys on
        it).  ``gains`` (K,) replace the static gains in this round's
        solve: float64 on the device for the 'jax' backend (a host array
        is copied there), a host array for 'numpy'.  Under dropout_rate >
        0 the straggler chain steps first, on ``straggler_u`` (K,) if
        given.  In population mode the round's cohort is ``cohort`` (a
        host ``population.CohortDraw``) or the next of the key chain
        (``draw_cohort``), drawn before the gradients."""
        n = self._round if n is None else n
        inp = self._host_inputs(n, self._round, cohort, straggler_u)
        if 'cohort' in inp:
            inp['cohort'] = inp['cohort'].to(self.device, non_blocking=True)
        if gains is not None:
            inp['gains'] = gains
        res = self._round_body(inp, self.draw() if draws is None else draws,
                               self._solve, self._round)
        self._round += 1
        return res

    # ------------------------------------------------------------------
    # fused rounds (round_fusion 'eager' | 'scan')
    # ------------------------------------------------------------------
    def _solve_f32(self, grads: torch.Tensor, gains=None, p_w=None):
        """Step 2 inside a fused round, float32 end to end (the
        reference's ``alloc_f32``): :func:`fused_stats`, the float32
        problem and one solver call (the ``alloc_solve_f32`` kernel on the
        card), with the round-0 guard as the solver's gate max(gb2) > 0:
        no host read.  ``gains`` and ``p_w`` (K,) default to the static
        geometry's and the budgets.  -> (sol, stats, q, p, objective,
        iters, exit_reason, 0.0) as :meth:`_solve`, device tensors."""
        fl = self.fl
        gains = self.gains_dev if gains is None else gains
        p_w = self.p_w_dev if p_w is None else p_w
        with record_function('round/stats'):
            g2, gb2, v, d2 = fused_stats(grads, self.gbar, fl.quant_bits)
            prob = alloc_jax.problem_from_stats(g2, gb2, v, d2, gains, p_w,
                                                self.dim, fl,
                                                dtype=torch.float32)
        with record_function('round/solve'):
            gate = None if fl.allocator == 'uniform' else torch.amax(gb2)
            sol = ops.alloc_solve(prob, fl.allocator,
                                  max_iters=fl.allocation_max_iters or 6,
                                  tol=fl.allocation_tol or 1e-5,
                                  early_exit=fl.allocation_early_exit,
                                  gate=gate)
        stats = dict(g2=g2, gb2=gb2, v=v, d2=d2, prob=prob)
        return (sol, stats, sol.q, sol.p, sol.objective, sol.iters,
                sol.exit_reason, 0.0)

    def _fused_host_inputs(self, n_run: int, n: int,
                           traj_host: Optional[np.ndarray]
                           ) -> Dict[str, torch.Tensor]:
        """A fused round's input slot (CPU tensors by field): the host
        loop's host-made inputs of that round (:meth:`_host_inputs`), the
        transport's host draws (``transport.host_draws``), the fading row
        and the round index."""
        fl = self.fl
        out = self._host_inputs(n_run, n)
        out['n'] = torch.tensor([n], dtype=torch.int64)
        n_retx = 1 if fl.transport == 'spfl_retx' else 0
        out.update(transport.host_draws(self.K, n_retx, fl.channel,
                                        self.host_gen, kind=fl.transport))
        if traj_host is not None:
            out['gains'] = torch.as_tensor(traj_host[n_run])
        return out

    def _fused_round(self, inp: Dict[str, torch.Tensor],
                     rand: Optional[torch.Tensor]):
        """One fused round from its input slot ``inp``
        (``training.fused.Staging``) and quantizer uniforms ``rand``: the
        round body with the float32 in-round solve, device operations
        only.  -> (condensed record, mean client loss)."""
        draws = transport.Draws(rand, **{f: inp[f] for f in _DRAW_FIELDS
                                         if f in inp})
        res = self._round_body(inp, draws, self._solve_f32, inp['n'][0])
        return res.telemetry.condensed(), res.losses.mean()

    def _fused_warm_up(self, stage: fused.Staging, stream):
        """One round on scratch copies of the carry and on slot 0, on the
        capture stream, before anything is captured: it loads the
        kernels, initialises cuDNN and the vmapped gradient and makes the
        capture stream's corrupt_fold accumulators (outside any graph's
        pool; the kernel leaves them zero).  The generators, parameters,
        ḡ, straggler state and ring stay where they were.  -> the round's
        record (the ring's prototype)."""
        carry = (self._params, self.comp, self.straggler)
        self._params = self._params.clone()
        self.comp = self.comp._replace(gbar=self.comp.gbar.clone())
        self.straggler = self.straggler.clone()
        try:
            with fused.on_stream(stream):
                rec, _ = self._fused_round(*stage.slot(0))
        finally:
            self._params, self.comp, self.straggler = carry
        return rec

    def _fused_setup(self, first: Dict[str, torch.Tensor],
                     seg_len: int) -> SimpleNamespace:
        """The buffers of the simulator's fused runs, shaped after a first
        input slot, with the warm-up round run on it (slot 0 of ``stage``
        holds it): the staging (and under 'eager' the one slot its graph
        reads), the telemetry ring (and the graph's one-slot ring), the
        loss slots, the capture stream and the graphs, captured at first
        use and kept by key ('eager', or the segment length).  Every later
        fused run reuses them: the graphs read and write these buffers and
        the carry at their addresses."""
        fl = self.fl
        eager = fl.round_fusion == 'eager'
        layout = fused.SlotLayout(first)
        rand_shape = None if fl.transport == 'onebit' else (self.K, self.dim)
        st = SimpleNamespace(
            eager=eager,
            stage=fused.Staging(layout, seg_len, rand_shape, self.device),
            static=(fused.Staging(layout, 1, rand_shape, self.device)
                    if eager else None),
            losses=torch.zeros((seg_len,), device=self.device),
            static_loss=torch.zeros((), device=self.device),
            stream=fused.side_stream(self.device),
            ring=None, out_ring=None, graphs={})
        return st

    def _fused_launcher(self, st: SimpleNamespace, m: int):
        """The callable that runs a segment's m rounds from ``st``'s
        staged slots: on the card the graph ('scan': one a segment length;
        'eager': one round's, behind device copies of each slot), captured
        at its first use; on the CPU the same body, run eagerly."""
        on_card = self.device.type == 'cuda'
        stage = st.stage

        def scan_rounds():
            for i in range(m):
                rec, loss = self._fused_round(*stage.slot(i))
                obs_ring.ring_write(st.ring, i, rec)
                st.losses[i].copy_(loss)

        def eager_round():
            rec, loss = self._fused_round(*st.static.slot(0))
            obs_ring.ring_write(st.out_ring, 0, rec)
            st.static_loss.copy_(loss)

        key = 'eager' if st.eager else m
        body = eager_round if st.eager else scan_rounds
        if on_card and key not in st.graphs:
            st.graphs[key] = fused.capture(body, st.stream)
        step = st.graphs[key].replay if on_card else body
        if not st.eager:
            return step

        def rounds():
            for i in range(m):
                st.static.dev[0].copy_(stage.dev[i])
                if stage.rand is not None:
                    st.static.rand[0].copy_(stage.rand[i])
                step()
                obs_ring.ring_copy(st.ring, i, st.out_ring, 0)
                st.losses[i].copy_(st.static_loss)
        return rounds

    def _run_fused(self, n_rounds: int, compute_bound: bool) -> FLHistory:
        """Segment-dispatched run (module docstring): 'scan' launches ONE
        graph a segment (kept by its length: at most two), 'eager' replays
        one round's graph once a round; on the CPU the same body runs
        eagerly.  The first fused run of a simulator warms up and sets up
        the buffers (:meth:`_fused_setup`); later runs reuse them and the
        graphs.  Refuses what the reference refuses, with its messages."""
        fl = self.fl
        if fl.round_fusion not in ('eager', 'scan'):
            raise ValueError(f'round_fusion must be none|eager|scan, '
                             f'got {fl.round_fusion!r}')
        if compute_bound:
            raise ValueError("compute_bound=True requires "
                             "round_fusion='none' (the Theorem-1 bound "
                             "needs host-side per-round stats)")
        if fl.transport in ALLOCATING and fl.allocation_backend != 'jax':
            raise ValueError("round_fusion requires "
                             "allocation_backend='jax' on allocating "
                             "transports (eq. (28) must solve in-trace)")
        hist = FLHistory()
        seg_len = fl.scan_segment_rounds or max(1, fl.telemetry_flush_every)
        sink = (JsonlSink(fl.telemetry_path, run_manifest(
                    fl, extra={'driver': 'fl_loop',
                               'round_fusion': fl.round_fusion},
                    device=self.device))
                if fl.telemetry_path else None)
        traj_host = self._fading_host(n_rounds)
        n0, comp_idx = self._round, self.comp.round_idx
        on_card = self.device.type == 'cuda'
        done = 0
        while done < n_rounds:
            m = min(seg_len, n_rounds - done)
            t0 = time.perf_counter()
            with self.trace.span('fused_segment'):
                # every host-made draw of the segment, at its boundary
                slots = [self._fused_host_inputs(done + i, n0 + done + i,
                                                 traj_host)
                         for i in range(m)]
                if self._fused is None:
                    self._fused = self._fused_setup(slots[0], seg_len)
                st = self._fused
                for i, values in enumerate(slots):
                    st.stage.put(i, values)
                    if st.stage.rand is not None:
                        st.stage.rand[i].uniform_(0.0, 1.0,
                                                  generator=self.gen)
                if st.ring is None:
                    st.stage.upload(m)
                    proto = self._fused_warm_up(st.stage, st.stream)
                    st.ring = obs_ring.ring_init(proto, seg_len)
                    if st.eager:
                        st.out_ring = obs_ring.ring_init(proto, 1)
                launch = self._fused_launcher(st, m)
                with self.segment_guard():
                    st.stage.upload(m)            # the segment's one copy
                    launch()
            # ---- the segment boundary: the run's only host syncs ----
            obs_ring.ring_written(st.ring, m)
            recs, _ = obs_ring.flush(st.ring)     # one device->host copy
            self._record_rows(recs, hist, sink)
            prev_loss = float(st.losses[m - 1])
            with record_function('round/evaluation'):
                loss, acc = self.global_metrics()
            hist.loss.append(loss)
            hist.test_acc.append(acc)
            hist.loss_delta.append(loss - prev_loss)
            if on_card:
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - t0
            # eq. (28) runs inside the round: no host stage to time
            hist.alloc_time_s.extend([0.0] * m)
            hist.round_time_s.extend([wall / m] * m)
            done += m
            self._round += m
        # a captured round rolls the state's round counter only when it
        # is captured: set it from the rounds run
        self.comp = self.comp._replace(round_idx=comp_idx + n_rounds)
        self.metrics.observe_alloc(host_solver_calls=self.host_solver_calls)
        if sink is not None:
            sink.write_spans(self.trace.summary())
            sink.write_metrics(self.metrics.snapshot())
            sink.close()
        return hist

    # ------------------------------------------------------------------
    def _record_rows(self, recs, hist: FLHistory, sink) -> None:
        """Flushed host records into ``sim.records``, the history's
        per-round lists, the metrics and the sink."""
        fl = self.fl
        packed_agreement = (fl.wire == 'packed' and fl.transport in
                            ('spfl', 'spfl_retx', 'error_free'))
        participation = fl.dropout_rate > 0.0 or (
            self.population and fl.cohort_sampler == 'availability')
        for rec in recs:
            self.records.append(rec)
            row = to_row(rec)
            hist.payload_bits.append(row['payload_bits'])
            hist.retransmissions.append(row['retransmissions'])
            hist.sign_ok_frac.append(row['sign_ok_frac'])
            hist.mod_ok_frac.append(row['mod_ok_frac'])
            hist.q_mean.append(row['q_mean'])
            hist.p_mean.append(row['p_mean'])
            if packed_agreement:
                hist.sign_agreement.append(row['sign_agreement'])
            hist.alloc_iters.append(row['alloc_iters'])
            hist.alloc_exit_reason.append(row['alloc_exit_reason'])
            if participation:
                hist.participation_frac.append(row['participation_frac'])
            if fl.screen:
                hist.suspect_frac.append(row['suspect_frac'])
            self.metrics.observe_round(row)
            if sink is not None:
                sink.write_round(row)

    def _fading_host(self, n_rounds: int) -> Optional[np.ndarray]:
        """Under ``allocation_cadence='per_round'`` (not population mode)
        on an allocating transport: the run's fading trajectory, kept on
        the device as ``self.trajectory`` (float64) and returned as a host
        array; else None."""
        fl = self.fl
        if not (fl.allocation_cadence == 'per_round' and fl.transport in
                ALLOCATING and not self.population):
            return None
        # population mode keys each device's shadowing by (id, round)
        traj = self.fading_trajectory(n_rounds).to(torch.float64)
        self.trajectory = traj.to(self.device)
        return traj.numpy()

    def run(self, n_rounds: int, eval_every: int = 1,
            compute_bound: bool = False) -> FLHistory:
        if self.fl.round_fusion != 'none':
            return self._run_fused(n_rounds, compute_bound)
        hist = FLHistory()
        fl = self.fl
        if compute_bound and fl.allocation_backend == 'jax':
            # the Theorem-1 bound needs the host problem and stats that
            # the on-device path never brings to the host
            raise ValueError("compute_bound=True requires "
                             "allocation_backend='numpy'")
        traj_host = self._fading_host(n_rounds)
        # telemetry: a device ring, flushed every telemetry_flush_every
        # rounds and after the last
        flush_every = max(1, fl.telemetry_flush_every)
        ring = None
        sink = (JsonlSink(fl.telemetry_path,
                          run_manifest(fl, extra={'driver': 'fl_loop'},
                                       device=self.device))
                if fl.telemetry_path else None)

        def flush_telemetry():
            recs, _ = obs_ring.flush(ring)          # one device->host copy
            self._record_rows(recs, hist, sink)

        for n in range(n_rounds):
            t0 = time.perf_counter()
            if traj_host is None:
                gains = None
            elif fl.allocation_backend == 'jax':
                gains = self.trajectory[n]       # a view: no host copy
            else:
                gains = traj_host[n]
            res = self.round_step(n=n, gains=gains)
            if compute_bound and res.allocation is not None:
                sol, stats = res.allocation, res.stats
                gsum = np.asarray(convergence.g_value_from_probs(
                    stats['prob'].coef, sol.p, sol.q))
                inp = convergence.bound_inputs_from_grads(stats['grads'],
                                                          stats['gbar'])
                hist.bound.append(float(convergence.one_step_bound(
                    fl.learning_rate, self.K, inp['g_global2'], inp['gb2'],
                    inp['g2'], inp['e2'], inp['v'], gsum)))
            rec = res.telemetry.condensed()
            if ring is None:
                ring = obs_ring.ring_init(rec, flush_every)
            obs_ring.ring_push(ring, rec)
            if n % eval_every == 0 or n == n_rounds - 1:
                prev_loss = float(res.losses.mean())
                with record_function('round/evaluation'):
                    loss, acc = self.global_metrics()
                hist.loss.append(loss)
                hist.test_acc.append(acc)
                hist.loss_delta.append(loss - prev_loss)
            if (n + 1) % flush_every == 0 or n == n_rounds - 1:
                flush_telemetry()
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            hist.alloc_time_s.append(res.alloc_time_s)
            hist.round_time_s.append(time.perf_counter() - t0)
        self.metrics.observe_alloc(host_solver_calls=self.host_solver_calls)
        if sink is not None:
            sink.write_spans(self.trace.summary())
            sink.write_metrics(self.metrics.snapshot())
            sink.close()
        return hist


@contextlib.contextmanager
def _cudnn_deterministic():
    """``torch.backends.cudnn.deterministic`` set inside the block (a
    process-wide flag, restored after)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


# the transport draws a fused round's input slot may hold
_DRAW_FIELDS = ('seeds', 'sign_u', 'mod_u', 'fate_u', 'h2')


def fused_stats(grads: torch.Tensor, gbar: torch.Tensor, bits: int):
    """The per-client scalars of a fused round's solve, float32 where the
    gradients lie (the reference's ``alloc_f32``): (g2, gb2, v, d2), each
    (K,), from the (K, l) gradients and the (l,) or (K, l) ḡ; d2 is the
    exact expected quantization MSE."""
    g = grads.detach()
    gb = (gbar if gbar.dim() == 2 else gbar.expand(g.shape)).detach()
    g2 = torch.sum(g ** 2, dim=1)
    gb2 = torch.sum(gb ** 2, dim=1)
    v = torch.sum(torch.abs(g) * gb, dim=1)
    return g2, gb2, v, expected_quant_mse(g, bits, dim=1)


# ---------------------------------------------------------------------------
def build_simulator(fl: FLConfig, per_device: int = 500,
                    n_test: int = 2000, iid: bool = False,
                    seed: Optional[int] = None,
                    device: DeviceLike = None) -> FLSimulator:
    """Paper §V setup: partitioned (synthetic-)CIFAR + CNN + wireless
    cell (``population_shards`` shards in population mode), on the CUDA
    card unless ``device='cpu'``."""
    from repro_torch.data import (
        dirichlet_partition, iid_partition, load_image_dataset,
        stack_client_data,
    )
    device = resolve(device)
    seed = fl.seed if seed is None else seed
    (x, y), (tx, ty) = load_image_dataset(seed=seed)
    # population mode makes S data shards, not N device data sets:
    # device d reads shard d mod S (population.shard_ids)
    k = fl.population_shards if fl.population_n > 0 else fl.n_devices
    if iid:
        parts = iid_partition(y, k, per_device, seed)
    else:
        parts = dirichlet_partition(y, k, per_device, fl.dirichlet_alpha,
                                    seed)
    cx, cy = stack_client_data(x, y, parts)
    return FLSimulator(fl, cx, cy, tx[:n_test], ty[:n_test], seed=seed,
                       device=device)
