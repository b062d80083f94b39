"""Population-scale device model: K-device cohorts sampled each round
from N registered devices (the port of ``repro.population``).

Nothing of size N is ever made.  Every device's static state (annulus
placement through ``channel.annulus_radius``, power class, availability
class, byzantine membership) is a function of (population key, device
id), and its AR(1) shadowing track of (device id, round), evaluated for
the sampled ids only, so a round costs O(K).  Each round keys a Feistel
bijection on the padded id domain, cycle-walked into [0, N), and reads
the first K (or ``OVERSAMPLE`` K) positions of that implicit random
permutation.  Device d reads data shard d mod S (:func:`shard_ids`).

The keys are ``core.threefry``'s, the reference's ``jax.random`` keys
word for word: given the same round key, the port samples the
reference's cohort bit for bit (ids, presence, power budgets, byzantine
membership), and its placement, gains and shadowing agree within a few
ulp (XLA's float32 ``pow`` and ``log1p`` are not PyTorch's).

The draw is O(K) bookkeeping with no input from the card, so the
simulator evaluates it on CPU tensors on the host and moves the cohort's
per-slot arrays to the card in one copy.  A Threefry call costs the same
for a few lanes or a few thousand, so :func:`draw_cohort` batches them by
level: the round's two keys; the Feistel round keys; every per-id stream
key of the candidates; their uniforms together with the shadowing
track's (window, ids) lag keys; the lag keys' normals.  The run-static
stream keys (``fold_in(base, FOLD)``) are made once (:func:`stream_keys`).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import channel
from repro_torch.core import threefry as tf
from repro_torch.core.quantize import true_div
from repro_torch.wire.corrupt import _fmix32

Tensor = torch.Tensor
MASK32 = tf.MASK32

COHORT_SAMPLERS = ('uniform', 'availability')

# fold_in constants, disjoint from every other stream of the reference
POPULATION_FOLD = 0x909C     # run seed -> population base key
PLACEMENT_FOLD = 0x917A      # per-device annulus placement u
POWER_FOLD = 0x50C5          # per-device power class
AVAIL_FOLD = 0xA7A1          # per-device availability class
SHADOW_FOLD = 0x5ADF         # per-(device, round) shadowing innovations
BYZ_ID_FOLD = 0xB17D         # per-device byzantine membership
COHORT_FOLD = 0xC040         # per-round cohort permutation key
ARRIVAL_FOLD = 0x0A21        # per-(device, round) arrival draw

# shadowing window W: the marginal variance is renormalized exactly; the
# truncation nudges only the lag correlations
SHADOW_WINDOW = 32
SHADOW_RHO = 0.9             # lag-1 coherence of a device's track
SHADOW_STD_DB = 4.0          # its marginal standard deviation
# candidate oversampling of the availability sampler
OVERSAMPLE = 4
# per-device power classes, dB relative to FLConfig.tx_power_dbm
POWER_CLASS_DB = (-3.0, 0.0, 3.0)

_FEISTEL_ROUNDS = 4
_WALK_STEPS = 32             # cycle-walk cap; P(escape) <= 2^-WALK_STEPS
_GOLDEN = 0x9E3779B9         # the round function is murmur3's finalizer
#                              (wire.corrupt._fmix32) of (lo + golden) ^ key

# the run-static streams of stream_keys, in its row order
STATIC_FOLDS = (PLACEMENT_FOLD, POWER_FOLD, AVAIL_FOLD, BYZ_ID_FOLD,
                SHADOW_FOLD)


def population_key(seed: int) -> Tensor:
    """The static per-device-state base key of a run, (2,) int64."""
    return tf.fold_in(tf.key(seed), POPULATION_FOLD)


def stream_keys(base_key: Tensor) -> Dict[int, Tensor]:
    """{FOLD: ``fold_in(base_key, FOLD)``} for each of ``STATIC_FOLDS``."""
    return dict(zip(STATIC_FOLDS,
                    tf.fold_in(base_key, torch.tensor(STATIC_FOLDS))))


def cohort_size(fl: FLConfig) -> int:
    """Effective per-round cohort width K (0 = legacy ``n_devices``)."""
    return fl.cohort_size or fl.n_devices


def _ids(ids) -> Tensor:
    return torch.as_tensor(ids, dtype=torch.int64) & MASK32


# ---------------------------------------------------------------------------
# lazily materialized per-device static state
# ---------------------------------------------------------------------------

def _per_device_uniform(base_key: Tensor, fold: int, ids) -> Tensor:
    """U(0,1) keyed by (base_key, fold, device id), (|ids|,) f32."""
    k = tf.fold_in(base_key, fold)
    return tf.uniform(tf.fold_in(k, _ids(ids)))


def _distances(u: Tensor, radius_m: float, min_m: float = 10.0) -> Tensor:
    return channel.annulus_radius(u, radius_m, min_m).to(torch.float32)


def _power_w(u: Tensor, base_w: float, class_db=POWER_CLASS_DB) -> Tensor:
    n = len(class_db)
    cls = torch.clamp((u * n).to(torch.int32), 0, n - 1)
    db = torch.tensor(class_db, dtype=torch.float32)[cls.long()]
    # 10 ** x in float64 rounded once: XLA's float32 power on these
    # three classes
    scale = torch.pow(10.0, true_div(db, 10.0).to(torch.float64))
    return (torch.tensor(base_w, dtype=torch.float32)
            * scale.to(torch.float32))


def _availability(u: Tensor, a_min: float) -> Tensor:
    a = torch.tensor(a_min, dtype=torch.float32)
    return a + (1.0 - a) * u


def device_distances(base_key: Tensor, ids, radius_m: float,
                     min_m: float = 10.0) -> Tensor:
    """Seeded annulus placement of the given device ids, (|ids|,) f32."""
    return _distances(_per_device_uniform(base_key, PLACEMENT_FOLD, ids),
                      radius_m, min_m)


def device_power_w(base_key: Tensor, ids, base_w: float,
                   class_db=POWER_CLASS_DB) -> Tensor:
    """Per-device power budget, (|ids|,) f32: ``base_w`` scaled by the
    device's static power class (uniform over ``class_db``)."""
    return _power_w(_per_device_uniform(base_key, POWER_FOLD, ids), base_w,
                    class_db)


def device_availability(base_key: Tensor, ids,
                        a_min: float = 0.3) -> Tensor:
    """Static per-device availability class in [a_min, 1], (|ids|,) f32."""
    return _availability(_per_device_uniform(base_key, AVAIL_FOLD, ids),
                         a_min)


def byzantine_ids(base_key: Tensor, ids, frac: float) -> Tensor:
    """Per-device byzantine membership, an i.i.d. Bernoulli(frac) per id,
    (|ids|,) bool."""
    u = _per_device_uniform(base_key, BYZ_ID_FOLD, ids)
    return u < torch.tensor(frac, dtype=torch.float32)


# ---------------------------------------------------------------------------
# reproducible per-(device, round) shadowing
# ---------------------------------------------------------------------------

def _window(rho: float, window: int):
    """The lag weights rho^j (j < W) and the scale c = sqrt((1 - rho^2) /
    (1 - rho^(2W))), float32 as the reference rounds them (rho^j a float64
    power rounded once, which is XLA's float32 power here; rho^2 and
    rho^(2W) by repeated squaring, as ``jnp``'s integer power)."""
    r = torch.tensor(rho, dtype=torch.float32)
    w = torch.pow(r.to(torch.float64),
                  torch.arange(window, dtype=torch.float64)).to(torch.float32)
    r2w, e = r, 2 * window
    acc = None
    while e > 0:
        if e & 1:
            acc = r2w if acc is None else acc * r2w
        e >>= 1
        if e > 0:
            r2w = r2w * r2w
    c = channel.sqrt_rounded((1.0 - r * r) / (1.0 - acc))
    return w, c


def _shadow_from_eps(eps: Tensor, rho: float, window: int) -> Tensor:
    """c * sum_j rho^j eps_j over the window axis 0, summed in order."""
    w, c = _window(rho, window)
    terms = w[:, None] * eps
    acc = terms[0]
    for j in range(1, window):
        acc = acc + terms[j]
    return c * acc


def _lag_counters(n, window: int) -> Tensor:
    """(n - j) mod 2^32 for j < W."""
    return (int(n) - torch.arange(window, dtype=torch.int64)) & MASK32


def shadow_at(base_key: Tensor, ids, n, rho: float = SHADOW_RHO,
              window: int = SHADOW_WINDOW) -> Tensor:
    """Shadowing state z_n of each device id at round ``n``, (|ids|,) f32:
    ``c * sum_{j<W} rho^j eps_{n-j}(d)`` with ``eps`` standard normals
    keyed by (device id, round n - j mod 2^32), Var[z] = 1 exactly."""
    kd = tf.fold_in(base_key, SHADOW_FOLD)
    keys = tf.fold_in(kd, _ids(ids))                       # (|ids|, 2)
    lag = tf.fold_in(keys[None], _lag_counters(n, window)[:, None])
    return _shadow_from_eps(tf.normal(lag), rho, window)


def _gains(d: Tensor, zeta: float, z: Optional[Tensor],
           shadow_std_db: float) -> Tensor:
    # d ** -zeta in float64 rounded once: within 1 ulp of XLA's float32
    # power, equal on ~99.9% of distances
    g = torch.pow(d.to(torch.float64), -float(torch.tensor(
        zeta, dtype=torch.float32))).to(torch.float32)
    if z is not None:
        g = channel.shadow_gains(g, z, shadow_std_db)
    return g


def cohort_gains(base_key: Tensor, ids, n, fl: FLConfig,
                 shadowing: bool = False,
                 shadow_std_db: float = SHADOW_STD_DB) -> Tensor:
    """Large-scale gains of the sampled cohort, (|ids|,) f32: placement ->
    path loss, times the device's shadowing track when ``shadowing``."""
    d = device_distances(base_key, ids, fl.cell_radius_m)
    z = shadow_at(base_key, ids, n) if shadowing else None
    return _gains(d, fl.path_loss_exp, z, shadow_std_db)


# ---------------------------------------------------------------------------
# O(K) seeded cohort sampling: Feistel permutation + cycle walking
# ---------------------------------------------------------------------------

def _feistel_apply(x: Tensor, round_keys, half_bits: int) -> Tensor:
    """One pass of the 4-round Feistel bijection on [0, 2^(2 half_bits))
    (int64 words; ``round_keys`` four uint32 ints or a (4,) tensor)."""
    mask = (1 << half_bits) - 1
    lo = x & mask
    hi = (x >> half_bits) & mask
    for r in range(_FEISTEL_ROUNDS):
        f = _fmix32(((lo + _GOLDEN) & MASK32) ^ int(round_keys[r]))
        hi, lo = lo, hi ^ (f & mask)
    return (hi << half_bits) | lo


def permuted_ids(key: Tensor, positions, n_pop: int) -> Tensor:
    """Positions of an implicit seeded random permutation of [0, n_pop),
    in O(|positions|): the Feistel bijection on the padded domain,
    cycle-walked back into [0, n_pop).  The walk stops once every lane is
    in range (the reference's remaining steps leave in-range lanes
    alone); a lane still out after ``_WALK_STEPS`` passes falls back to
    its position."""
    if not 0 < n_pop <= 2 ** 31:
        raise ValueError(f'population size must be in (0, 2^31], '
                         f'got {n_pop}')
    nbits = max(2, math.ceil(math.log2(n_pop)))
    nbits += nbits % 2                     # even split for the halves
    half = nbits // 2
    rk = tf.bits(key, (_FEISTEL_ROUNDS,)).tolist()
    pos = _ids(positions)
    x = _feistel_apply(pos, rk, half)
    for _ in range(_WALK_STEPS - 1):
        out = x >= n_pop
        if not bool(out.any()):
            break
        x = torch.where(out, _feistel_apply(x, rk, half), x)
    return torch.where(x < n_pop, x, pos)


class Cohort(NamedTuple):
    """One round's sampled cohort."""
    ids: Tensor       # (K,) int64 — distinct global device ids (uint32)
    present: Tensor   # (K,) bool — arrived this round (False rows are the
    #   ragged-cohort padding: zero-weight rows of the transport)
    p_w: Tensor       # (K,) f32 — per-device power budgets (power class)


class CohortDraw(NamedTuple):
    """A cohort with the per-id state the round consumes."""
    cohort: Cohort
    gains: Optional[Tensor]       # (K,) f32 large-scale gains
    byzantine: Optional[Tensor]   # (K,) bool byzantine membership


def validate(fl: FLConfig) -> int:
    """-> the cohort width K; raises on a cohort wider than the
    population or an unknown sampler."""
    k = cohort_size(fl)
    if k > fl.population_n:
        raise ValueError(f'cohort_size {k} > population_n {fl.population_n}')
    if fl.cohort_sampler not in COHORT_SAMPLERS:
        raise ValueError(f'cohort_sampler must be one of '
                         f'{COHORT_SAMPLERS}, got {fl.cohort_sampler!r}')
    return k


def draw_cohort(round_key: Tensor, streams: Dict[int, Tensor],
                fl: FLConfig, n=0,
                gains: bool = True, shadowing: bool = False,
                byzantine: bool = False) -> CohortDraw:
    """Round ``round_key``'s cohort (:func:`sample_cohort`) with its
    gains at round ``n`` (:func:`cohort_gains`, if ``gains``) and its
    byzantine membership (:func:`byzantine_ids` at ``fl.attack_frac``, if
    ``byzantine``), the Threefry calls batched by level.  ``streams`` is
    :func:`stream_keys` of the population key.  CPU tensors."""
    k = validate(fl)
    n_pop = fl.population_n
    avail = fl.cohort_sampler == 'availability'
    perm_key, arrival_key = tf.fold_in(
        round_key, torch.tensor([COHORT_FOLD, ARRIVAL_FOLD]))
    m = min(OVERSAMPLE * k, n_pop) if avail else k
    cand = permuted_ids(perm_key, torch.arange(m), n_pop)

    # every per-id stream key the round needs, over the candidates
    folds = ([POWER_FOLD] + [PLACEMENT_FOLD] * gains
             + [AVAIL_FOLD, ARRIVAL_FOLD] * avail + [BYZ_ID_FOLD] * byzantine)
    rows = {f: arrival_key if f == ARRIVAL_FOLD else streams[f]
            for f in folds}
    shadow = gains and shadowing
    if shadow:
        rows[SHADOW_FOLD] = streams[SHADOW_FOLD]
    keys = tf.fold_in(torch.stack(list(rows.values()))[:, None], cand)
    names = list(rows)
    n_u = len(names) - shadow          # the streams read as one uniform

    # their uniforms (counter (0, 0)) and the lag keys (0, n - j) at once
    k0 = keys[:n_u, :, 0].reshape(-1)
    k1 = keys[:n_u, :, 1].reshape(-1)
    x1 = torch.zeros_like(k0)
    if shadow:
        lags = _lag_counters(n, SHADOW_WINDOW)[:, None].expand(-1, m)
        sk = keys[n_u]
        k0 = torch.cat([k0, sk[:, 0].expand(SHADOW_WINDOW, m).reshape(-1)])
        k1 = torch.cat([k1, sk[:, 1].expand(SHADOW_WINDOW, m).reshape(-1)])
        x1 = torch.cat([x1, lags.reshape(-1)])
    b0, b1 = tf.threefry2x32(k0, k1, 0, x1)
    u = dict(zip(names, tf.uniform_from_bits(
        (b0 ^ b1)[:n_u * m]).reshape(n_u, m)))

    if avail:
        arrived = u[ARRIVAL_FOLD] < _availability(u[AVAIL_FOLD],
                                                  fl.availability_min)
        # stable partition: arrivals first in permutation order, absentees
        # after — the slots past the arrival count are the ragged padding
        idx = torch.arange(m)
        order = torch.argsort(torch.where(arrived, idx, m + idx),
                              stable=True)[:k]
        present = arrived[order]
    else:
        order = torch.arange(k)
        present = torch.ones((k,), dtype=torch.bool)
    ids = cand[order]
    cohort = Cohort(ids, present,
                    _power_w(u[POWER_FOLD][order], fl.tx_power_w))
    g = byz = None
    if byzantine:
        byz = u[BYZ_ID_FOLD][order] < torch.tensor(fl.attack_frac,
                                                   dtype=torch.float32)
    if gains:
        z = None
        if shadow:
            lag_keys = torch.stack((b0[n_u * m:], b1[n_u * m:]), dim=-1)
            eps = tf.normal(lag_keys.reshape(SHADOW_WINDOW, m, 2)[:, order])
            z = _shadow_from_eps(eps, SHADOW_RHO, SHADOW_WINDOW)
        g = _gains(_distances(u[PLACEMENT_FOLD][order], fl.cell_radius_m),
                   fl.path_loss_exp, z, SHADOW_STD_DB)
    return CohortDraw(cohort, g, byz)


def sample_cohort(round_key: Tensor, base_key: Tensor,
                  fl: FLConfig) -> Cohort:
    """Seeded per-round cohort draw, O(cohort_size).  ``'uniform'`` reads K
    positions of the round's implicit permutation; ``'availability'``
    thins ``OVERSAMPLE * K`` candidates by their per-round arrival draw
    (``U < availability(id)``), keeps the first K arrivals in permutation
    order and backfills a shortfall with absent candidates
    (``present=False``)."""
    return draw_cohort(round_key, stream_keys(base_key), fl,
                       gains=False).cohort


class CohortRound(NamedTuple):
    """A population round's cohort on the training device."""
    ids: Tensor                   # (K,) int64 global device ids
    shards: Tensor                # (K,) int64 data shard of each id
    present: Optional[Tensor]     # (K,) bool arrivals (availability
    #                               sampler only; None = everyone)
    p_w: Tensor                   # (K,) float64 of the f32 budgets
    gains: Optional[Tensor]       # (K,) float64 of the f32 gains
    byzantine: Optional[Tensor]   # (K,) bool (attack != 'none')


def cohort_columns(draw: CohortDraw, n_shards: int) -> Tensor:
    """A host cohort draw's per-slot arrays stacked as (K, C) float64
    columns on the host (ids < 2^32 and the float32 budgets and gains
    are exact there): ids, shards, presence, budgets, then the gains and
    the byzantine flags where the draw has them — one copy moves a
    round's cohort to the device."""
    c = draw.cohort
    cols = [c.ids, shard_ids(c.ids, n_shards), c.present, c.p_w]
    if draw.gains is not None:
        cols.append(draw.gains)
    if draw.byzantine is not None:
        cols.append(draw.byzantine)
    return torch.stack([col.to(torch.float64) for col in cols], dim=1)


def cohort_round(cols: Tensor, fl: FLConfig, gains: bool) -> CohortRound:
    """The :class:`CohortRound` of (K, C) :func:`cohort_columns` on the
    device (device operations only); ``gains``: the columns hold them."""
    dev = cols.unbind(1)
    byz = dev[-1] > 0.0 if fl.attack != 'none' else None
    present = (dev[2] > 0.0 if fl.cohort_sampler == 'availability'
               else None)
    return CohortRound(dev[0].to(torch.int64), dev[1].to(torch.int64),
                       present, dev[3], dev[4] if gains else None, byz)


def shard_ids(ids, n_shards: int) -> Tensor:
    """Virtual device -> data shard: device ``d`` reads shard ``d mod S``."""
    return (_ids(ids) % n_shards).to(torch.int32)


def combine_active(present: Optional[Tensor],
                   straggler_active: Optional[Tensor]) -> Optional[Tensor]:
    """A client contributes only if its device arrived AND its slot is not
    stalled; ``None`` means everyone on either side."""
    if present is None:
        return straggler_active
    if straggler_active is None:
        return present
    return present & straggler_active
