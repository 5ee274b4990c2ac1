"""Worker process for the 2-process jax.distributed CPU test.

Each process owns 4 virtual CPU devices; together they form the 8-device
``data`` mesh. The program is the multi-host recipe from
``parallel/multihost.py``: initialize jax.distributed, build the global mesh,
run the DataParallelRunner segment, and verify params stay replicated across
the local shards. Launched by tests/test_multihost.py.

The worker always runs on the CPU: several of these processes start on one
machine, and on a GPU each JAX process would reserve most of the card's
memory when it first touched it, so the second would fail.

Usage: multihost_worker.py <coordinator> <num_processes> <process_id>
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    coordinator, nproc, pid = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    )
    import jax

    from deepqlearning_tpu.parallel.multihost import (
        hybrid_mesh,
        initialize_multihost,
        local_shard_info,
        pod_data_mesh,
        pod_shard_plan,
    )

    initialize_multihost(coordinator, nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    # pod-shaped meshes: the 2-D (DCN x ICI) mesh has one row per process
    # with that process's devices ICI-contiguous; the flat data mesh is its
    # ICI-major flattening (so the all-reduce is hierarchical on real pods)
    hm = hybrid_mesh()
    assert hm.devices.shape == (nproc, jax.local_device_count()), hm.devices.shape
    for row in range(nproc):
        owners = {d.process_index for d in hm.devices[row]}
        assert len(owners) == 1, owners  # each row = one process's chips
    mesh = pod_data_mesh()
    n_local, n_global, my_pid = local_shard_info(mesh)
    assert n_global == n_local * nproc, (n_local, n_global)
    assert my_pid == pid
    # per-process shard arithmetic
    plan = pod_shard_plan(global_num_envs=16, batch_size=8, mesh=mesh)
    assert plan.envs_per_device == 16 // n_global
    assert plan.local_envs == plan.envs_per_device * n_local
    assert plan.process_count == nproc
    try:
        pod_shard_plan(global_num_envs=n_global + 1, batch_size=8, mesh=mesh)
        raise AssertionError("indivisible env count must be rejected")
    except ValueError:
        pass

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deepqlearning_tpu import (
        Chain,
        Dense,
        DQNConfig,
        Flatten,
        TestMDP,
        create_dueling_network,
    )
    from deepqlearning_tpu.parallel.mesh import DataParallelRunner
    from deepqlearning_tpu.replay.prioritized import PrioritizedReplayBuffer

    env = TestMDP((5, 5), 4, 6)
    chain = Chain(Flatten(), Dense(100, 16, jnp.tanh),
                  Dense(16, env.num_actions))
    network = create_dueling_network(chain)
    cfg = DQNConfig(num_envs=2, batch_size=8, buffer_size=64, train_freq=2,
                    train_start=8, max_episode_length=6)
    buffer = PrioritizedReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size, prioritized=True)
    runner = DataParallelRunner(
        env, network, buffer, cfg, lambda t: jnp.asarray(0.5),
        gamma=env.discount, mesh=mesh)

    # every process computes the identical full carry (same seed), then
    # device_puts it to the global data sharding — each process materializes
    # only its addressable shards
    carry = runner.init_carry(jax.random.PRNGKey(0))

    def to_global(x):
        spec = P(*(("data",) + (None,) * (np.asarray(x).ndim - 1)))
        return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))

    carry = jax.tree_util.tree_map(to_global, carry)
    carry = runner.run_populate(carry, 8)
    carry = runner.run_segment(carry, 3)

    # loss is finite on every shard this process owns
    loss_shards = [np.asarray(s.data) for s in carry.loss.addressable_shards]
    assert all(np.isfinite(ls).all() for ls in loss_shards), loss_shards
    # params replicated: every local shard of every leaf matches shard 0
    leaf = jax.tree_util.tree_leaves(carry.params)[0]
    shards = [np.asarray(s.data) for s in leaf.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_allclose(shards[0], s, rtol=1e-6)
    print(f"OK pid={pid} local_devices={n_local} loss0={loss_shards[0]}")


if __name__ == "__main__":
    main()
