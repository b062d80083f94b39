"""The port's ``launch.env`` (the counterpart of ``repro.launch.env``):
the overrides, the record of the process-wide settings, and the run
manifest's ``'env'`` block.  Every test restores what ``configure``
changed (torch's default dtype is process-wide, and the suite's workers
run other files after this one); the reference's ``configure`` is not
called here, since it updates ``jax.config`` for the whole worker.
"""
from __future__ import annotations

import json
import os

import pytest
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.launch import env
from repro_torch.obs import sink

OVERRIDES = ('REPRO_PLATFORM', 'REPRO_X64', 'JAX_ENABLE_X64',
             'REPRO_HOST_DEVICES', 'CUBLAS_WORKSPACE_CONFIG')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread (the suite runs in several workers), restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def restored(monkeypatch):
    """The overrides unset, torch's default dtype and the recorded state
    put back after each test."""
    for name in OVERRIDES:
        monkeypatch.setenv(name, '')      # recorded, so restored after
        monkeypatch.delenv(name)
    dtype = torch.get_default_dtype()
    state = dict(env._STATE)
    yield
    torch.set_default_dtype(dtype)
    env._STATE.clear()
    env._STATE.update(state)


def test_defaults_are_the_card_and_float32():
    state = env.configure()
    assert state == {'configured': True, 'platform': 'gpu', 'x64': False,
                     'host_device_count': None}
    assert torch.get_default_dtype() == torch.float32


@pytest.mark.parametrize('given,want', [('gpu', 'gpu'), ('cuda', 'gpu'),
                                        ('cpu', 'cpu'), ('CPU', 'cpu')])
def test_platform_argument(given, want):
    assert env.configure(platform=given)['platform'] == want


@pytest.mark.parametrize('name', ['tpu', 'rocm'])
def test_other_platforms_raise(name, monkeypatch):
    with pytest.raises(ValueError, match='gpu'):
        env.configure(platform=name)
    monkeypatch.setenv('REPRO_PLATFORM', name)
    with pytest.raises(ValueError, match='gpu'):
        env.configure()


def test_environment_overrides(monkeypatch):
    monkeypatch.setenv('REPRO_PLATFORM', 'cpu')
    monkeypatch.setenv('REPRO_X64', '1')
    monkeypatch.setenv('REPRO_HOST_DEVICES', '8')
    state = env.configure()
    assert (state['platform'], state['x64'], state['host_device_count']) \
        == ('cpu', True, 8)
    assert torch.get_default_dtype() == torch.float64
    assert torch.zeros(1).dtype == torch.float64
    # an argument wins over the environment
    state = env.configure(platform='gpu', use_x64=False, host_device_count=2)
    assert (state['platform'], state['x64'], state['host_device_count']) \
        == ('gpu', False, 2)
    assert torch.get_default_dtype() == torch.float32


def test_jax_enable_x64_is_honoured_when_repro_x64_is_unset(monkeypatch):
    monkeypatch.setenv('JAX_ENABLE_X64', '1')
    assert env.configure()['x64'] is True
    monkeypatch.setenv('REPRO_X64', '0')
    assert env.configure()['x64'] is False


def test_cublas_workspace_is_pinned_and_recorded(monkeypatch):
    assert env.resolved_state()['cublas_workspace_config'] is None
    assert env.pin_cublas_workspace() == env.CUBLAS_WORKSPACE_CONFIG
    assert os.environ['CUBLAS_WORKSPACE_CONFIG'] == ':4096:8'
    assert env.resolved_state()['cublas_workspace_config'] == ':4096:8'
    # an existing setting is kept
    monkeypatch.setenv('CUBLAS_WORKSPACE_CONFIG', ':16:8')
    assert env.pin_cublas_workspace() == ':16:8'


def test_the_record_reads_the_live_settings():
    env.configure(platform='cpu')
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.get_float32_matmul_precision(),
              torch.backends.cudnn.benchmark)
    try:
        torch.use_deterministic_algorithms(True)
        torch.set_float32_matmul_precision('high')
        torch.backends.cudnn.benchmark = True
        state = env.resolved_state()
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.set_float32_matmul_precision(before[2])
        torch.backends.cudnn.benchmark = before[3]
    assert state['configured'] and state['platform'] == 'cpu'
    assert state['deterministic_algorithms'] is True
    assert state['float32_matmul_precision'] == 'high'
    assert state['cudnn_benchmark'] is True
    assert state['intra_op_threads'] == torch.get_num_threads()
    assert state['torch'] == torch.__version__
    assert state['device_name'] == 'cpu' and state['device_count'] == 0
    for key in ('tf32_matmul', 'tf32_cudnn', 'cudnn_deterministic',
                'inter_op_threads', 'cuda', 'default_dtype',
                'x64_enabled'):
        assert key in state
    assert env.resolved_state()['deterministic_algorithms'] is before[0]


def test_manifest_embeds_env():
    env.configure(platform='cpu')
    man = sink.run_manifest(FLConfig(), device='cpu')
    assert 'env' in sink.MANIFEST_KEYS
    assert set(sink.MANIFEST_KEYS) <= set(man)
    assert man['env']['platform'] == 'cpu' and man['env']['configured']
    assert man['env'] == json.loads(json.dumps(man['env']))


def test_manifest_keys_are_the_references():
    """The reference's keys but its JAX-only ones ('jax', 'xla_flags'),
    whose place 'torch' takes."""
    from repro.obs import sink as ref_sink
    want = set(ref_sink.MANIFEST_KEYS) - {'jax', 'xla_flags'} | {'torch'}
    assert set(sink.MANIFEST_KEYS) == want


def test_drivers_configure_first(monkeypatch, tmp_path):
    """``launch.train.main`` and ``launch.serve.main`` run
    ``env.configure`` before their run; ``--device cpu`` records the CPU,
    and ``REPRO_PLATFORM=cpu`` without ``--device`` picks it."""
    import argparse
    from repro_torch.launch import serve, train
    seen = {}

    def fake_run(*args, **kw):
        seen['state'] = dict(env._STATE)
        seen['device'] = kw.get('device')
        return {}

    monkeypatch.setattr(train, 'run', fake_run)
    monkeypatch.setattr(serve, 'run', fake_run)
    train.main(['--device', 'cpu', '--steps', '1'])
    assert seen['state']['configured'] and seen['state']['platform'] == 'cpu'
    env._STATE.clear()
    monkeypatch.setenv('REPRO_PLATFORM', 'cpu')
    serve.main([])
    assert seen['state']['platform'] == 'cpu' and seen['device'] == 'cpu'
    args = argparse.Namespace(device=None)
    monkeypatch.delenv('REPRO_PLATFORM')
    assert env.configure_driver(args)['platform'] == 'gpu'
    assert args.device is None


def test_launcher_manifest_records_the_cublas_setting(tmp_path, monkeypatch):
    """A deterministic launcher run pins the cuBLAS workspace, and its
    telemetry manifest shows it under 'env'."""
    from repro_torch.launch import train
    path = tmp_path / 't.jsonl'
    env.configure(platform='cpu')
    train.run('smollm-135m-reduced', steps=1, clients=2, batch=1, seq=8,
              transport_kind='spfl', allocator='uniform', lr=0.05,
              bandwidth_hz=10e9, tx_power_dbm=-4.0, device='cpu',
              deterministic=True, telemetry_path=str(path))
    man = json.loads(path.read_text().splitlines()[0])
    assert man['type'] == 'manifest'
    assert man['env']['cublas_workspace_config'] == ':4096:8'
    assert man['env']['platform'] == 'cpu'
