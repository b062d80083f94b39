"""The port's copies of the reference's configurations: ``ModelConfig``
(an architecture of the model zoo, with its analytic parameter count and
its ``reduced()`` CPU variant), ``ShapeConfig`` and ``INPUT_SHAPES`` (the
launchers' input shapes), and ``FLConfig`` — the federated-learning /
wireless system constants of the paper's §V.

Same field names, defaults and derived properties as the reference
dataclasses, so a reference config converts with
``FLConfig(**dataclasses.asdict(ref_fl))`` (``ModelConfig`` likewise).

``training.fl_loop.FLSimulator`` runs ``transport`` in {spfl, spfl_retx,
dds, onebit, scheduling, error_free}, ``wire`` in {analytic, packed},
``channel`` in {bernoulli, bitlevel} (bitlevel with spfl/spfl_retx needs
the packed wire), every ``compensation``, ``allocation_backend`` in
{numpy, jax}, ``allocation_cadence`` in {static, per_round}, ``attack``
in {none, signflip, scaled, labelflip}, ``screen``, ``dropout_rate`` with
``straggler_stickiness``, ``min_participation``, population cohorts
(``population_n > 0``, ``cohort_size``, ``cohort_sampler``,
``population_shards``, ``availability_min``), the telemetry sink
(``telemetry_path``, ``telemetry_flush_every``) and every
``round_fusion``.  Like the reference's, its spfl rounds never read
``collective`` (its one-device flat round is 'gather' either way; the
error_free transport refuses 'sharded' without a mesh, as the
reference's does).  The LLM-scale step
(``training.distributed``) and its launcher (``launch.train``) run
``collective='sharded'`` over a ``core.mesh.ClientMesh`` (packed wire
only), ``round_fusion`` 'eager' and 'scan', and population mode.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


# Layer kinds usable in ``layer_pattern`` (tiled over n_layers):
#   'attn'        global (full causal) attention
#   'swa'         sliding-window causal attention (cfg.sliding_window)
#   'mamba'       Mamba2 SSD block
#   'shared_attn' attention block whose weights are SHARED across all
#                 occurrences (Zamba2-style shared transformer block)
LAYER_KINDS = ('attn', 'swa', 'mamba', 'shared_attn')


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ''
    head_dim: Optional[int] = None      # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    topk: int = 0
    dense_residual: bool = False        # Arctic-style parallel dense FFN
    capacity_factor: float = 1.25
    # --- attention pattern ---
    sliding_window: int = 0             # 0 = always full attention
    layer_pattern: Tuple[str, ...] = ('attn',)
    attn_softcap: float = 0.0           # gemma2 soft-capping of attn logits
    logit_softcap: float = 0.0          # gemma2 soft-capping of final logits
    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # --- modality frontend (STUB per harness carve-out) ---
    frontend: str = 'none'              # none | vision | audio
    n_prefix_tokens: int = 0            # vision patches / audio frames
    frontend_embed_dim: int = 0         # dim of the precomputed embeddings
    # --- block structure ---
    post_norm: bool = False             # gemma2 pre+post sublayer norms
    embed_scale: bool = False           # gemma-family sqrt(d) embed scaling
    # --- perf knobs (§Perf hillclimbing; defaults = paper-faithful) ---
    remat_policy: str = 'full'          # full | dots | none
    q_chunk: int = 1024                 # attention query-chunk length
    moe_dispatch: str = 'flat'          # flat | grouped (per-batch-row)
    decode_cache_layout: str = 'hd'     # hd | batch (KV cache sharding)
    # --- numerics ---
    norm_eps: float = 1e-6
    param_dtype: str = 'bfloat16'
    # long-context capability flag (decides long_500k applicability)
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return all(k == 'mamba' for k in self.layer_pattern)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim

    def layer_kinds(self) -> Tuple[str, ...]:
        """The concrete kind of each of the n_layers layers."""
        pat = self.layer_pattern
        reps = math.ceil(self.n_layers / len(pat))
        return tuple((pat * reps)[: self.n_layers])

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d, ff, hd = self.d_model, self.d_ff, self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        n_attn = d * q + 2 * d * kv + q * d          # wq, wk, wv, wo
        if self.qkv_bias:
            n_attn += q + 2 * kv
        n_mlp_dense = 3 * d * ff                     # gate, up, down
        total = 0
        shared_attn_counted = False
        for kind in self.layer_kinds():
            total += d  # pre-norm
            if kind == 'mamba':
                inner = self.ssm_inner
                nh = self.ssm_heads
                # in_proj -> z, x, B, C, dt ; out_proj
                total += d * (2 * inner + 2 * self.ssm_state + nh)
                total += inner * d
                total += self.conv_width * (inner + 2 * self.ssm_state)
                total += 2 * nh  # A_log, D
                total += inner   # gated rmsnorm
            else:
                if kind == 'shared_attn':
                    if shared_attn_counted:
                        continue
                    shared_attn_counted = True
                total += n_attn + d  # attn + post-norm
                if self.is_moe:
                    total += d * self.n_experts           # router
                    total += self.n_experts * n_mlp_dense  # experts
                    if self.dense_residual:
                        total += n_mlp_dense
                else:
                    total += n_mlp_dense
        total += self.vocab_size * d                  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d              # lm head
        total += d                                    # final norm
        if self.frontend != 'none':
            total += max(self.frontend_embed_dim, d) * d  # projector
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE top-k instead of all experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        n_mlp = 3 * d * ff
        inactive = 0
        for kind in self.layer_kinds():
            if kind != 'mamba':
                inactive += (self.n_experts - self.topk) * n_mlp
        return self.param_count() - inactive

    # ------------------------------------------------------------------
    def reduced(self) -> 'ModelConfig':
        """Harness-mandated smoke-test variant of the same family."""
        d = min(self.d_model, 256)
        hd = 32
        n_heads = max(2, min(4, self.n_heads))
        # preserve the GQA/MQA flavour
        if self.n_kv_heads == 1:
            n_kv = 1
        elif self.n_kv_heads == self.n_heads:
            n_kv = n_heads
        else:
            n_kv = max(1, n_heads // 2)
        n_layers = min(2, self.n_layers)
        pat = self.layer_pattern
        if len(pat) > n_layers:
            # keep one of each kind present
            kinds = []
            for k in pat:
                if k not in kinds:
                    kinds.append(k)
            pat = tuple(kinds[:n_layers]) or ('attn',)
            n_layers = max(n_layers, len(pat))
        return dataclasses.replace(
            self,
            name=self.name + '-reduced',
            n_layers=n_layers,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            topk=min(self.topk, 2) if self.topk else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            layer_pattern=pat,
            n_prefix_tokens=min(self.n_prefix_tokens, 4) if self.n_prefix_tokens else 0,
            frontend_embed_dim=min(self.frontend_embed_dim, 64) if self.frontend_embed_dim else 0,
            param_dtype='float32',
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    'train_4k': ShapeConfig('train_4k', 4_096, 256, 'train'),
    'prefill_32k': ShapeConfig('prefill_32k', 32_768, 32, 'prefill'),
    'decode_32k': ShapeConfig('decode_32k', 32_768, 128, 'decode'),
    'long_500k': ShapeConfig('long_500k', 524_288, 1, 'decode'),
}


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
