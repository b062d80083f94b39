"""The port's drivers (``python -m repro_torch.examples.<name>``, the
counterparts of the reference's ``examples/``), each at its reduced
default on ``--device cpu``: quickstart for one round, the allocation
demo whole (q held above p as the power falls: the paper's Remark 2),
fl_train_lm on the reduced SmolLM for two steps, serve_batched on the
reduced SmolLM.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.launch import env


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def restored():
    """The drivers call ``env.configure``: its record and torch's default
    dtype are put back after each test."""
    state, dtype = dict(env._STATE), torch.get_default_dtype()
    yield
    env._STATE.clear()
    env._STATE.update(state)
    torch.set_default_dtype(dtype)


def test_quickstart_one_round(capsys, monkeypatch):
    from repro_torch.examples import quickstart
    monkeypatch.setenv('ROUNDS', '1')
    out = quickstart.main(['--device', 'cpu'])
    assert set(out) == {'spfl', 'error_free'}
    for hist in out.values():
        assert len(hist.loss) == 1 and math.isfinite(hist.loss[0])
        assert 0.0 <= hist.test_acc[0] <= 1.0
    assert out['error_free'].sign_ok_frac == [1.0]
    text = capsys.readouterr().out
    assert '== transport=spfl ==' in text
    assert 'mean modulus-packet success' in text
    assert env._STATE['platform'] == 'cpu'


def test_allocation_demo_holds_q_above_p(capsys):
    from repro_torch.examples import allocation_demo
    rows = allocation_demo.main(['--device', 'cpu'])
    assert [r['power_dbm'] for r in rows] == list(allocation_demo.POWERS_DBM)
    q = np.array([r['q'] for r in rows])
    p = np.array([r['p'] for r in rows])
    assert np.all(np.isfinite(q)) and np.all(np.isfinite(p))
    # Remark 2: the sign packet is protected as the power falls
    assert np.all(q >= p)
    assert np.all(np.diff(q - p) >= 0) and q[-1] - p[-1] > 0.05
    assert np.all(np.diff(p) <= 0)
    # Remark 1: bandwidth follows ||g_k||^2
    assert all(r['corr_g2_beta'] > 0.5 for r in rows)
    assert 'Remark 2' in capsys.readouterr().out


def test_fl_train_lm_reduced():
    from repro_torch.examples import fl_train_lm
    h = fl_train_lm.main(['--steps', '2', '--device', 'cpu'])
    assert len(h['loss']) == 2 and all(math.isfinite(x) for x in h['loss'])
    assert all(0.0 <= x <= 1.0 for x in h['q'] + h['p'])


def test_serve_batched_reduced():
    from repro_torch.examples import serve_batched
    out = serve_batched.main(['--device', 'cpu'])
    assert tuple(out['output'].shape) == (4, 16)
    assert out['output'].dtype == torch.int32
    assert int(out['output'].min()) >= 0
    assert int(out['output'].max()) < 512
    assert out['tokens_per_s'] > 0


def test_drivers_default_to_the_card(monkeypatch):
    """Without ``--device`` a driver runs on the card, and raises here."""
    from repro_torch.examples import serve_batched
    monkeypatch.delenv('REPRO_PLATFORM', raising=False)
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='CUDA card'):
        serve_batched.main([])
