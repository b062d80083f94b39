"""The port's copy of ``FLConfig`` — the federated-learning / wireless
system constants of the paper's §V.

Same field names, defaults and derived properties as the reference
dataclass, so a reference config converts with
``FLConfig(**dataclasses.asdict(ref_fl))``.  The port runs ``transport``
in {spfl, spfl_retx, dds, onebit, scheduling, error_free}, ``wire`` in
{analytic, packed}, ``channel`` in {bernoulli, bitlevel} (bitlevel with
spfl/spfl_retx needs the packed wire), every ``compensation``,
``allocation_backend`` in {numpy, jax}, ``allocation_cadence`` in
{static, per_round}, ``attack`` in {none, signflip, scaled, labelflip},
``screen``, ``dropout_rate`` with ``straggler_stickiness``,
``min_participation``, population cohorts (``population_n > 0``,
``cohort_size``, ``cohort_sampler``, ``population_shards``,
``availability_min``), the telemetry sink (``telemetry_path``,
``telemetry_flush_every``), ``round_fusion='none'`` and
``collective='gather'``;
``training.fl_loop.FLSimulator`` raises ``NotImplementedError`` on the
other knobs, naming the ``ROADMAP.md`` item that brings each.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class FLConfig:
    n_devices: int = 20                  # K
    bandwidth_hz: float = 10e6           # B
    path_loss_exp: float = 3.0           # zeta
    noise_psd_dbm: float = -174.0        # N0 (dBm/Hz)
    tx_power_dbm: float = -4.0           # P
    quant_bits: int = 3                  # b
    b0_bits: int = 64                    # bits for (gmin, gmax)
    latency_s: float = 0.5               # tau
    learning_rate: float = 0.05          # eta
    dirichlet_alpha: float = 0.5
    cell_radius_m: float = 500.0
    lipschitz: Optional[float] = None    # default 1/eta (paper sets L = 1/eta)
    compensation: str = 'last_global'    # last_global | last_local | zeros | seeded_random
    transport: str = 'spfl'              # spfl | dds | onebit | scheduling | error_free
    allocator: str = 'alternating'       # alternating | barrier | uniform
    scheduling_ratio: float = 0.75
    seed: int = 0
    uplink_reduce_dtype: str = 'float32'   # float32 | bfloat16
    alpha_max: float = 1.0               # cap on the sign-packet power share
    wire: str = 'analytic'               # analytic | packed
    channel: str = 'bernoulli'           # bernoulli | bitlevel
    collective: str = 'gather'           # gather | sharded (packed wire)
    allocation_backend: str = 'numpy'    # numpy | jax
    allocation_cadence: str = 'static'   # static | per_round
    allocation_max_iters: int = 0        # 0 = auto: 2 alternating, 6 barrier
    #   on the numpy backend; 6 for both on the jax backend
    allocation_tol: float = 0.0          # 0 = engine default 1e-5
    allocation_early_exit: bool = True   # while_loop early exit (jax)
    telemetry_flush_every: int = 8       # ring capacity / flush cadence
    telemetry_path: Optional[str] = None  # JSONL sink (None = in-memory)
    round_fusion: str = 'none'           # none | eager | scan
    scan_segment_rounds: int = 0         # 0 = telemetry_flush_every
    attack: str = 'none'                 # none | signflip | scaled | labelflip
    attack_frac: float = 0.25            # byzantine fraction (floor(f*K))
    attack_scale: float = 10.0           # 'scaled' range inflation factor
    dropout_rate: float = 0.0            # stationary straggler fraction
    straggler_stickiness: float = 0.5    # stalled-state persistence
    screen: bool = False                 # packed-domain byzantine defense
    screen_z: float = 4.0                # robust-z suspicion threshold
    min_participation: float = 0.0       # mod-packet floor -> sign-only
    population_n: int = 0                # registered devices N (0 = legacy)
    cohort_size: int = 0                 # sampled clients/round (0 = n_devices)
    cohort_sampler: str = 'uniform'      # uniform | availability
    population_shards: int = 64          # data shards S for d -> d mod S
    availability_min: float = 0.3        # floor of per-device availability

    @property
    def noise_psd_w(self) -> float:
        return 10 ** (self.noise_psd_dbm / 10) / 1000.0

    @property
    def tx_power_w(self) -> float:
        return 10 ** (self.tx_power_dbm / 10) / 1000.0

    @property
    def lipschitz_const(self) -> float:
        return self.lipschitz if self.lipschitz is not None else 1.0 / self.learning_rate
