"""``repro_torch.core.compensation`` against ``repro.core.compensation``:
the four ḡ policies through init, current and update, on the same
aggregates and gradients (and, for seeded_random, the reference's own
normals).  Every value is exact: the policies are abs, a copy, or
|normal| * 0.01 in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compensation as RCMP
from repro_torch.core import compensation as CMP

K, L = 5, 97


@pytest.mark.parametrize('kind', CMP.KINDS)
def test_policy_matches_reference(kind):
    assert CMP.KINDS == RCMP.KINDS
    rng = np.random.RandomState(CMP.KINDS.index(kind))
    st_r = RCMP.init_state(kind, jnp.zeros((L,)), K)
    st = CMP.init_state(kind, torch.zeros(L), K)
    assert st.kind_id == st_r.kind_id
    assert CMP.per_client(kind) == RCMP.per_client(kind)
    np.testing.assert_array_equal(st.gbar.numpy(), np.asarray(st_r.gbar))
    seed = 1234
    for _ in range(3):
        if kind == 'seeded_random':
            normals = np.array(jax.random.normal(
                jax.random.fold_in(jax.random.PRNGKey(seed), st_r.round_idx),
                st_r.gbar.shape, jnp.float32))
            got = CMP.current_gbar(kind, st, torch.as_tensor(normals))
        else:
            got = CMP.current_gbar(kind, st)
        ref = RCMP.current_gbar(kind, st_r, seed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert bool((got >= 0).all())
        agg = (rng.randn(L) * 0.1).astype(np.float32)
        grads = (rng.randn(K, L) * 0.1).astype(np.float32)
        st_r = RCMP.update_state(kind, st_r, jnp.asarray(agg),
                                 jnp.asarray(grads))
        st = CMP.update_state(kind, st, torch.as_tensor(agg),
                              torch.as_tensor(grads))
        assert st.round_idx == int(st_r.round_idx)
        np.testing.assert_array_equal(st.gbar.numpy(), np.asarray(st_r.gbar))


def test_seeded_random_from_a_generator_and_errors():
    st = CMP.init_state('seeded_random', torch.zeros(L), K)
    gen = torch.Generator().manual_seed(3)
    got = CMP.current_gbar('seeded_random', st, generator=gen)
    want = torch.abs(torch.randn(L, generator=torch.Generator()
                                 .manual_seed(3))) * 0.01
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        CMP.current_gbar('seeded_random', st)
    with pytest.raises(ValueError):
        CMP.init_state('previous', torch.zeros(L), K)
    with pytest.raises(ValueError):
        CMP.update_state('last_local', CMP.init_state('last_local',
                                                      torch.zeros(L), K),
                         torch.zeros(L))
