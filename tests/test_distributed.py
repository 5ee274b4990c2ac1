"""Data-parallel mesh tests on the simulated 8-device CPU mesh
(SURVEY.md §4: the analog of multi-node tests).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from deepqlearning_tpu import (
    Chain,
    Dense,
    DQNConfig,
    Flatten,
    TestMDP,
    create_dueling_network,
)
from deepqlearning_tpu.parallel.mesh import DataParallelRunner, make_mesh
from deepqlearning_tpu.replay.prioritized import PrioritizedReplayBuffer
from deepqlearning_tpu.solver.exploration import LinearDecaySchedule

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 simulated devices"
)


def _runner(n_dev=8, **cfg_kw):
    env = TestMDP((5, 5), 4, 6)
    chain = Chain(Flatten(), Dense(100, 16, jnp.tanh), Dense(16, env.num_actions))
    network = create_dueling_network(chain)
    cfg = DQNConfig(
        num_envs=2, batch_size=8, buffer_size=64, train_freq=2,
        train_start=8, max_episode_length=6, **cfg_kw
    )
    buffer = PrioritizedReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size, prioritized=True
    )
    mesh = make_mesh(n_dev)
    return DataParallelRunner(
        env, network, buffer, cfg, LinearDecaySchedule(1.0, 0.1, 100),
        gamma=env.discount, mesh=mesh,
    )


def test_dp_step_runs_and_keeps_params_replicated():
    runner = _runner()
    carry = runner.init_carry(jax.random.PRNGKey(0))
    carry = runner.run_populate(carry, 8)
    carry = runner.run_segment(carry, 3)
    assert np.isfinite(float(carry.loss[0]))
    leaf = jax.tree_util.tree_leaves(carry.params)[0]
    for d in range(1, runner.n_devices):
        np.testing.assert_allclose(
            np.asarray(leaf[0]), np.asarray(leaf[d]), rtol=1e-6
        )


def test_dp_replay_shards_differ():
    runner = _runner()
    carry = runner.init_carry(jax.random.PRNGKey(0))
    carry = runner.run_populate(carry, 8)
    # each device collected its own experience: reward shards differ
    # (decoded scalar column 1 = reward in the merged-row layout)
    rew = np.asarray(carry.replay.rows[..., -3])
    assert rew.shape[0] == 8
    assert not np.allclose(rew[0], rew[1])


def test_dp_env_steps_advance():
    runner = _runner()
    carry = runner.init_carry(jax.random.PRNGKey(0))
    carry = runner.run_segment(carry, 5)
    # each device advanced num_envs * steps_per_iter * 5 steps
    t = np.asarray(carry.actor.t)
    assert (t == t[0]).all() and t[0] == 5 * runner.cfg.env_steps_per_iter


def test_pod_mesh_helpers_single_process():
    # single-process degrade: hybrid mesh is 1 x N, flat mesh covers all
    # devices, shard plan arithmetic checks out
    from deepqlearning_tpu.parallel.multihost import (
        hybrid_mesh,
        pod_data_mesh,
        pod_shard_plan,
    )

    hm = hybrid_mesh()
    assert hm.devices.shape == (1, len(jax.devices()))
    assert hm.axis_names == ("dcn", "ici")
    flat = pod_data_mesh()
    assert flat.devices.size == len(jax.devices())
    plan = pod_shard_plan(global_num_envs=32, batch_size=8, mesh=flat)
    assert plan.envs_per_device * plan.global_devices == 32
    assert plan.local_envs == 32  # single process owns everything
    with pytest.raises(ValueError, match="divisible"):
        pod_shard_plan(global_num_envs=flat.devices.size + 1, batch_size=8,
                       mesh=flat)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (256, 4)
    ge.dryrun_multichip(8)


def test_dp_recurrent_path():
    from deepqlearning_tpu import LSTM
    from deepqlearning_tpu.replay.episode import EpisodeReplayBuffer

    env = TestMDP((5, 5), 1, 6)
    network = Chain(Flatten(), LSTM(25, 8), Dense(8, env.num_actions))
    cfg = DQNConfig(
        num_envs=2, batch_size=4, buffer_size=16, train_freq=2,
        train_start=8, max_episode_length=6, recurrence=True,
        trace_length=5, dueling=False,
    )
    buffer = EpisodeReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size, cfg.trace_length,
        cfg.max_episode_length, num_envs=cfg.num_envs,
    )
    runner = DataParallelRunner(
        env, network, buffer, cfg, LinearDecaySchedule(1.0, 0.1, 100),
        gamma=env.discount, mesh=make_mesh(8),
    )
    carry = runner.init_carry(jax.random.PRNGKey(0))
    carry = runner.run_populate(carry, 8)  # enough steps to commit episodes
    carry = runner.run_segment(carry, 2)
    assert np.isfinite(float(carry.loss[0]))
    leaf = jax.tree_util.tree_leaves(carry.params)[0]
    np.testing.assert_allclose(np.asarray(leaf[0]), np.asarray(leaf[-1]),
                               rtol=1e-6)


def _hier_runner(shape=(2, 4), dcn_sync_every=1):
    env = TestMDP((5, 5), 4, 6)
    chain = Chain(Flatten(), Dense(100, 16, jnp.tanh), Dense(16, env.num_actions))
    network = create_dueling_network(chain)
    cfg = DQNConfig(
        num_envs=2, batch_size=8, buffer_size=64, train_freq=2,
        train_start=8, max_episode_length=6,
    )
    buffer = PrioritizedReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size, prioritized=True
    )
    grid = np.asarray(jax.devices()[: shape[0] * shape[1]]).reshape(shape)
    mesh = Mesh(grid, ("dcn", "ici"))
    return DataParallelRunner(
        env, network, buffer, cfg, LinearDecaySchedule(1.0, 0.1, 100),
        gamma=env.discount, mesh=mesh, dcn_sync_every=dcn_sync_every,
    )


def test_hierarchical_psum_matches_flat_pmean():
    """psum(psum(g, ici), dcn) over a 2x4 (dcn, ici) mesh must produce the
    same trained params as the flat 8-device pmean (same seed, same device
    order) up to reduction-order rounding (VERDICT r4 next-step #4)."""
    flat = _runner(8)
    hier = _hier_runner((2, 4))
    key = jax.random.PRNGKey(3)
    cf = flat.run_populate(flat.init_carry(key), 8)
    ch = hier.run_populate(hier.init_carry(key), 8)
    cf = flat.run_segment(cf, 4)
    ch = hier.run_segment(ch, 4)
    pf = jax.tree_util.tree_leaves(flat.device_get_params(cf))
    ph = jax.tree_util.tree_leaves(hier.device_get_params(ch))
    for a, b in zip(pf, ph):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-6)


def test_local_sgd_dcn_sync_mode():
    """dcn_sync_every=k: slices drift between syncs (grads reduce over ICI
    only) and re-converge at sync boundaries — params must be identical
    across the dcn axis right after a segment whose length is a multiple
    of k, and finite throughout."""
    hier = _hier_runner((2, 4), dcn_sync_every=2)
    carry = hier.init_carry(jax.random.PRNGKey(5))
    carry = hier.run_populate(carry, 8)
    carry = hier.run_segment(carry, 4)   # 4 % 2 == 0: ends on a sync
    assert np.all(np.isfinite(np.asarray(carry.loss)))
    leaf = jax.tree_util.tree_leaves(carry.params)[0]
    # identical across dcn rows (synced), identical across ici always
    np.testing.assert_allclose(np.asarray(leaf[0]), np.asarray(leaf[1]),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(leaf[0, 0]), np.asarray(leaf[0, 3]),
                               rtol=1e-6)
