"""The port's obs layer (``repro_torch.obs``) against the reference's
(``repro.obs``): ``to_row`` of a port record equals the reference's
``to_row`` of the same host values; the ring's flush returns the pushed
records oldest first and wraps; ``condensed`` keeps the agreement;
``MetricsRegistry.snapshot`` and ``config_hash`` equal the reference's;
a CPU run with ``telemetry_path`` writes a JSONL whose rows are the
run's ``FLHistory``; ``telemetry_path`` and ``population_n`` no longer
raise, the other unported knobs still do."""
import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as RefFLConfig
from repro.obs import metrics as RM
from repro.obs import record as RR
from repro.obs import sink as RS
from repro_torch.configs.base import FLConfig
from repro_torch.obs import metrics as TM
from repro_torch.obs import record as TR
from repro_torch.obs import ringbuf as TRing
from repro_torch.obs import sink as TS
from repro_torch.obs import trace as TT
from repro_torch.training import fl_loop

K, L = 4, 256


def _fields(i=0, votes=False, crc=False, adversarial=False, cohort=False,
            alloc=True):
    """One record's fields as NumPy values."""
    rng = np.random.RandomState(i)
    f = dict(sign_ok=np.array([True, True, False, True]),
             mod_ok=np.array([True, False, True, True]),
             accepted=np.array([True, True, False, True]),
             payload_bits=np.float32(1000.0 + i),
             retransmissions=np.float32(i))
    if votes:
        f['sign_votes'] = rng.randint(0, 4, L).astype(np.int32)
    if crc:
        f.update(sign_crc_ok=np.array([True, False, True, True]),
                 mod_crc_ok=np.zeros(K, bool),
                 sign_flips=rng.randint(0, 9, K).astype(np.int32),
                 mod_flips=rng.randint(0, 9, K).astype(np.int32),
                 retx_attempts=np.array([0, 1, 0, 0], np.int32))
    if adversarial:
        f.update(active=np.array([True, True, False, True]),
                 suspect=np.array([False, True, False, False]),
                 suspicion=np.array([0.1, 9.0, 0.0, 0.2], np.float32))
    if cohort:
        f['cohort_ids'] = np.array([17, 999_999, 2 ** 31, 5], np.int64)
    if alloc:
        f.update(q=np.linspace(0.55, 0.97, K).astype(np.float32),
                 p=np.linspace(0.91, 0.33, K).astype(np.float32),
                 alloc_objective=np.float32(0.123 + i),
                 round_idx=i, alloc_iters=np.int32(3),
                 alloc_exit_reason=np.int32(0))
    return f


def _ref(f):
    kw = {k: (v if k == 'round_idx' else jnp.asarray(v)) for k, v in
          f.items()}
    if 'cohort_ids' in kw:
        kw['cohort_ids'] = kw['cohort_ids'].astype(jnp.uint32)
    return RR.RoundTelemetry(**kw)


def _port(f):
    return TR.RoundTelemetry(**{
        k: (v if k == 'round_idx' else torch.as_tensor(np.asarray(v)))
        for k, v in f.items()})


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def _rows_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert _same(a[k], b[k]), (k, a[k], b[k])


CASES = {
    'plain': dict(alloc=False),
    'votes': dict(votes=True),
    'crc': dict(votes=True, crc=True),
    'adversarial': dict(votes=True, crc=True, adversarial=True),
    'cohort': dict(crc=True, cohort=True),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_to_row_matches_reference(case):
    f = _fields(3, **CASES[case])
    _rows_equal(TR.to_row(_port(f).to_host()), RR.to_row(_ref(f)))


@pytest.mark.parametrize('case', sorted(CASES))
def test_condensed_keeps_the_agreement(case):
    f = _fields(5, **CASES[case])
    port, ref = _port(f), _ref(f)
    cond, ref_cond = port.condensed(), ref.condensed()
    assert cond.sign_votes is None
    if 'sign_votes' in f:
        assert float(cond.agreement) == float(ref_cond.agreement)
        assert float(cond.agreement) == TR.to_row(port.to_host())[
            'sign_agreement']
    _rows_equal(TR.to_row(cond.to_host()), RR.to_row(ref_cond))


def test_agreement_is_nan_without_accepted_packets():
    f = _fields(1, votes=True)
    f['sign_ok'] = np.zeros(K, bool)
    assert math.isnan(float(_port(f).condensed().agreement))
    no_votes = TR.sign_agreement(None, torch.ones(K, dtype=torch.bool))
    assert math.isnan(float(no_votes))


@pytest.mark.parametrize('case', sorted(CASES))
def test_round_scalars_match_to_row(case):
    f = _fields(2, **CASES[case])
    port = _port(f)
    s = TR.round_scalars(port)
    assert set(s) == set(TR.SCALAR_KEYS) == set(RR.SCALAR_KEYS)
    assert set(TR.SCALAR_KEYS) <= set(fl_loop.FLHistory().as_dict())
    row = TR.to_row(port.to_host())
    for k in TR.SCALAR_KEYS:
        assert _same(float(s[k]), row[k]), k
    assert TR.VECTOR_KEYS == RR.VECTOR_KEYS


def test_ring_flush_returns_records_oldest_first_and_resets():
    ring = TRing.ring_init(_port(_fields(0, crc=True, cohort=True))
                           .condensed(), 4)
    for i in range(3):
        TRing.ring_push(ring, _port(_fields(i, crc=True, cohort=True)))
    recs, ring = TRing.flush(ring)
    assert [int(r.round_idx) for r in recs] == [0, 1, 2]
    for i, r in enumerate(recs):
        want = _fields(i, crc=True, cohort=True)
        _rows_equal(TR.to_row(r), TR.to_row(_port(want).to_host()))
        assert r.cohort_ids.dtype == np.int64
    assert ring.idx == 0
    assert TRing.flush(ring)[0] == []


def test_ring_wraps_oldest_first():
    ring = TRing.ring_init(_port(_fields(0)), 3)
    for i in range(5):                         # 5 pushes into capacity 3
        TRing.ring_push(ring, _port(_fields(i)))
    recs, _ = TRing.flush(ring)
    assert [int(r.round_idx) for r in recs] == [2, 3, 4]
    assert [float(r.payload_bits) for r in recs] == [1002.0, 1003.0, 1004.0]


def test_ring_refuses_another_layout():
    ring = TRing.ring_init(_port(_fields(0)), 2)
    with pytest.raises(ValueError, match='layout'):
        TRing.ring_push(ring, _port(_fields(1, crc=True)))


def test_ring_keeps_host_values_on_the_host():
    f = _fields(0)
    rec = _port(f)._replace(alloc_objective=0.5, alloc_iters=2)
    ring = TRing.ring_init(rec, 2)
    assert set(ring.host_fields) == {'round_idx', 'alloc_objective',
                                     'alloc_iters'}
    TRing.ring_push(ring, rec._replace(round_idx=7))
    (out,), _ = TRing.flush(ring)
    assert out.round_idx == 7 and out.alloc_objective == 0.5


def _rows(n):
    rows = []
    for i in range(n):
        f = _fields(i, **CASES[sorted(CASES)[i % len(CASES)]])
        rows.append(RR.to_row(_ref(f)))
    return rows


def test_metrics_snapshot_matches_reference():
    ref, port = RM.MetricsRegistry(), TM.MetricsRegistry()
    for row in _rows(300):                 # past the reservoir's size
        ref.observe_round(row)
        port.observe_round(row)
    for reg in (ref, port):
        reg.observe_alloc(host_solver_calls=3, outer_residual=1e-4)
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot()['transport']['payload_bits']['events'] == 300


@pytest.mark.parametrize('kw', [
    {}, dict(n_devices=4, population_n=1000, cohort_size=4,
             population_shards=6, telemetry_path='t.jsonl'),
    dict(attack='signflip', screen=True, lipschitz=2.5)])
def test_config_hash_equals_the_references(kw):
    assert ([f.name for f in dataclasses.fields(FLConfig)]
            == [f.name for f in dataclasses.fields(RefFLConfig)])
    assert TS.config_hash(FLConfig(**kw)) == RS.config_hash(
        RefFLConfig(**kw))
    assert TS.config_hash(None) is None


def test_manifest_keys_and_torch_section():
    man = TS.run_manifest(FLConfig(), extra={'driver': 'x'},
                          device=torch.device('cpu'))
    assert set(TS.MANIFEST_KEYS) <= set(man)
    assert man['torch']['version'] == torch.__version__
    assert man['torch']['device'] == 'cpu'
    assert man['config_hash'] == TS.config_hash(FLConfig())
    assert man['driver'] == 'x'


def test_sink_round_trip(tmp_path):
    path = str(tmp_path / 'sub' / 't.jsonl')
    rows = _rows(3)
    with TS.JsonlSink(path, {'k': 1}) as sink:
        for row in rows:
            sink.write_round(dict(row, round=None))
        sink.write_spans({'update': {'count': 1}})
    man, back = TS.read_jsonl(path)
    assert man == {'type': 'manifest', 'k': 1}
    assert [r['round'] for r in back] == [0, 1, 2]
    assert json.loads(open(path).read().splitlines()[-1])['type'] == 'spans'


def test_stage_trace_summary():
    tr = TT.StageTrace(annotate=True)
    for _ in range(3):
        with tr.span('update'):
            pass
    s = tr.summary()['update']
    assert s['count'] == 3 and s['total_s'] >= 0.0
    assert len(tr.durations('update')) == 3
    with TT.stage_scope('psum'):
        pass
    tr.reset()
    assert tr.summary() == {}
    assert TT.null_trace() is TT.null_trace()
    assert TT.STAGES[0] == 'alloc_solve'


# ---------------------------------------------------------------------------
# the host loop
# ---------------------------------------------------------------------------

def _hist_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert _same(float(x), float(y)), (a, b)


def test_run_writes_the_history_to_the_jsonl(tmp_path):
    path = str(tmp_path / 't.jsonl')
    fl = FLConfig(n_devices=4, population_n=1000, cohort_size=4,
                  population_shards=6, allocation_backend='jax',
                  allocator='uniform', wire='packed', channel='bitlevel',
                  cohort_sampler='availability', availability_min=0.2,
                  telemetry_path=path, telemetry_flush_every=2)
    sim = fl_loop.build_simulator(fl, per_device=16, n_test=64, device='cpu')
    hist = sim.run(3)
    man, rows = TS.read_jsonl(path)
    assert man['config_hash'] == TS.config_hash(fl)
    assert man['driver'] == 'fl_loop'
    assert [r['round'] for r in rows] == [0, 1, 2]
    for key in ('payload_bits', 'retransmissions', 'sign_ok_frac',
                'mod_ok_frac', 'q_mean', 'p_mean', 'sign_agreement',
                'alloc_iters', 'alloc_exit_reason', 'participation_frac'):
        _hist_equal([r[key] for r in rows], getattr(hist, key))
    for r, rec in zip(rows, sim.records):
        assert r['cohort_ids'] == rec.cohort_ids.tolist()
        assert len(set(r['cohort_ids'])) == 4
        assert all(0 <= i < 1000 for i in r['cohort_ids'])
    lines = [json.loads(line) for line in open(path)]
    assert [ln['type'] for ln in lines] == (['manifest'] + ['round'] * 3
                                            + ['spans', 'metrics'])
    assert lines[-2]['spans']['alloc_solve']['count'] == 3
    assert lines[-2]['spans']['update']['count'] == 3
    assert lines[-1]['metrics']['allocation']['host_solver_calls'][
        'value'] == 0.0


@pytest.mark.parametrize('kw', [
    dict(telemetry_path='t.jsonl'), dict(population_n=1000)])
def test_telemetry_and_population_left_the_unported_list(kw):
    fl = FLConfig(**kw)
    assert not hasattr(fl_loop, '_NOT_YET')   # nothing is left unported
    fl_loop.check_supported(dataclasses.replace(
        fl, allocation_backend='jax'))


@pytest.mark.parametrize('kw', [
    dict(round_fusion='eager'), dict(round_fusion='scan'),
    dict(collective='sharded')])
def test_remaining_items_still_raise(kw):
    """Fused rounds left the unported list, and so did the sharded
    collective: the host loop never reads it (the reference's does not
    either).  On the LLM-scale step 'sharded' runs with a mesh and
    refuses only a missing one, with the reference's message."""
    assert not hasattr(fl_loop, '_NOT_YET')   # nothing is left unported
    if 'round_fusion' in kw:
        fl_loop.check_supported(FLConfig(allocation_backend='jax', **kw))
        return
    fl_loop.check_supported(FLConfig(**kw))
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import distributed
    cfg = get_arch('smollm-135m-reduced')
    with pytest.raises(ValueError, match='needs the mesh'):
        distributed.make_fl_train_step(cfg, FLConfig(**kw))
    assert callable(distributed.make_fl_train_step(
        cfg, FLConfig(**kw), mesh=make_host_mesh()))
