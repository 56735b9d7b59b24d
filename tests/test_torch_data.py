"""The port's synthetic data (``repro_torch.data``) against the reference's
(``repro.data``): the same tokens, targets and mask, bit for bit, over
several (vocabulary, length, batch, seed, step), GLM-4-9B's vocabulary of
151,552 at 2048 positions among them; its threefry twin
(``repro_torch.data.prng``) against ``jax.random`` (keys, splits and
uniforms bitwise, normals within 2e-5: XLA's float32 erfinv against a
float64 one); ``spectral_field`` within 1e-5 of its max; and the
reference's own properties (tests/test_data.py).
"""

import jax
import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st

from repro.data import SyntheticLMData as RefData, spectral_field as ref_field
from repro_torch.data import SyntheticLMData, prng, spectral_field

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores, and the
    small ops here lose more to a crowded thread pool than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [(256, 16, 4, 0, 0), (256, 16, 4, 3, 7), (97, 32, 2, 1, 0), (4096, 256, 4, 0, 99),
         (151552, 2048, 4, 0, 1), (151552, 2048, 4, 5, 3)]


@pytest.mark.parametrize("V,S,B,seed,step", CASES)
def test_batch_equals_reference(V, S, B, seed, step):
    want = RefData(vocab=V, seq_len=S, global_batch=B, seed=seed).batch(step)
    got = SyntheticLMData(vocab=V, seq_len=S, global_batch=B, seed=seed).batch(step)
    for k in ("tokens", "targets", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (123456789, 1000)])
def test_threefry_twin_matches_jax(seed, step):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    mine = prng.fold_in(prng.prng_key(seed), step)
    np.testing.assert_array_equal(mine, np.asarray(key))
    np.testing.assert_array_equal(prng.split(mine, 5), np.asarray(jax.random.split(key, 5)))
    for shape, lo in (((3, 33), 0.0), ((4, 2049), 1e-6), ((1000,), -1.0)):
        np.testing.assert_array_equal(prng.uniform(mine, shape, minval=lo),
                                      np.asarray(jax.random.uniform(key, shape, minval=lo)))
    np.testing.assert_allclose(prng.normal(mine, (64, 64)),
                               np.asarray(jax.random.normal(key, (64, 64))), rtol=0, atol=2e-5)


def test_spectral_field_matches_reference():
    want = np.asarray(ref_field(jax.random.PRNGKey(3), (16, 12, 8), modes=4))
    got = spectral_field(prng.prng_key(3), (16, 12, 8), modes=4).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_batch_determinism():
    d = SyntheticLMData(vocab=128, seq_len=16, global_batch=4, seed=3)
    b1, b2 = d.batch(7), d.batch(7)
    for k in b1:
        np.testing.assert_array_equal(b1[k].numpy(), b2[k].numpy())
    assert not np.array_equal(b1["tokens"].numpy(), d.batch(8)["tokens"].numpy())


@given(pc=st.sampled_from([1, 2, 4]), step=st.integers(0, 100))
@settings(max_examples=20, deadline=None)
def test_host_shards_partition_batch(pc, step):
    d = SyntheticLMData(vocab=64, seq_len=8, global_batch=8, seed=0)
    full = d.batch(step)
    parts = [d.host_local_batch(step, process_index=i, process_count=pc) for i in range(pc)]
    for k in full:
        np.testing.assert_array_equal(np.concatenate([p[k].numpy() for p in parts]),
                                      full[k].numpy())


def test_targets_are_next_token_predictable():
    """Targets stay in range and the inputs are the shifted targets."""
    b = SyntheticLMData(vocab=97, seq_len=32, global_batch=2, seed=1).batch(0)
    toks, tgt = b["tokens"].numpy(), b["targets"].numpy()
    assert toks.min() >= 0 and toks.max() < 97
    np.testing.assert_array_equal(toks[:, 1:], tgt[:, :-1])
