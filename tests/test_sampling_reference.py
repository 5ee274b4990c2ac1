"""Sum-tree sampling against numpy, and the merged priority write.

Integer priorities make every partial sum exact in float32, so the descent
must land on exactly the leaf that ``np.searchsorted`` finds on the
cumulative sum, at every tree depth (up to 2^20 leaves: four levels with a
two-stage one-hot fetch at the widest)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepqlearning_tpu import PrioritizedReplayBuffer
from deepqlearning_tpu.ops import sumtree
from reference_impl import random_transitions


def _int_tree(cap, seed=0):
    prios = np.random.default_rng(seed).integers(1, 9, size=cap).astype(
        np.float32)
    return prios, sumtree.set_priorities(sumtree.init_tree(cap),
                                         jnp.arange(cap), jnp.asarray(prios))


@pytest.mark.parametrize("cap,draws", [(64, 512), (4096, 512),
                                       (1 << 19, 4096), (1 << 20, 4096)])
def test_sample_matches_searchsorted_on_cumsum(cap, draws):
    prios, tree = _int_tree(cap, seed=cap)
    key = jax.random.PRNGKey(cap)
    idx, p = sumtree.sample(tree, key, draws)
    # the same float32 stratified masses the sampler forms
    u = np.asarray(jax.random.uniform(key, (draws,)), np.float32)
    u = (np.arange(draws, dtype=np.float32) + u) / np.float32(draws)
    mass = u * np.float32(prios.sum(dtype=np.float64))
    want = np.searchsorted(np.cumsum(prios, dtype=np.float64), mass,
                           side="right")
    np.testing.assert_array_equal(np.asarray(idx), want)
    np.testing.assert_array_equal(np.asarray(p), prios[want])


def test_stratified_draw_counts_follow_priorities():
    # one stratified pass: every leaf is drawn within 2 of its share
    cap, draws = 256, 8192
    prios, tree = _int_tree(cap, seed=1)
    idx, _ = sumtree.sample(tree, jax.random.PRNGKey(2), draws)
    counts = np.bincount(np.asarray(idx), minlength=cap)
    expect = draws * prios / prios.sum()
    assert np.abs(counts - expect).max() <= 2.0


def test_sample_n_is_u_major_over_strata():
    # sub-batch u takes strata {u, U+u, 2U+u, ...} of ONE stratified pass
    B, U, n = 16, 4, 256
    buf = PrioritizedReplayBuffer((3,), n, B)
    st = buf.insert(buf.init(),
                    random_transitions(jax.random.PRNGKey(0), n, 3))
    key = jax.random.PRNGKey(1)
    _, idx, _ = buf.sample_n(st, key, U)
    flat, _ = sumtree.sample(st.tree, key, U * B)
    want = np.asarray(flat).reshape(B, U).T.reshape(-1)
    np.testing.assert_array_equal(np.asarray(idx), want)


def test_duplicate_draws_keep_the_last_priority_write():
    # a row drawn in several sub-updates keeps the latest one's priority,
    # as sequential updates would leave it
    buf = PrioritizedReplayBuffer((2,), 16, 4, alpha=0.6, eps=1e-3)
    st = buf.init()
    idx = jnp.asarray([3, 5, 3, 7, 5, 3, 0], jnp.int32)
    td = jnp.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])
    out = buf.update_priorities(st, idx, td)
    want = np.zeros(16)
    for i, t in zip(np.asarray(idx), np.asarray(td)):
        want[i] = (abs(t) + 1e-3) ** 0.6             # sequential: last wins
    np.testing.assert_allclose(np.asarray(out.tree[0]), want, rtol=1e-6)
    np.testing.assert_allclose(float(sumtree.total(out.tree)), want.sum(),
                               rtol=1e-6)
