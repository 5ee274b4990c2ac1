"""DRQN loop throughput on one GPU.

Same method as ``bench.py`` (one jitted scan of full iterations per rep,
ending in ``jax.block_until_ready``; median and quartiles over reps) on the
recurrent path: LSTM(obs→32) Q-network and EpisodeReplayBuffer (merged
shadow-row ring, sliced window gathers); data/update ratio 4096:1. Needs an
NVIDIA GPU; fails without one.

Run: ``python scripts/drqn_bench.py`` (``BENCH_ENVS``, ``BENCH_ITERS``,
``BENCH_REPS``). Prints one JSON line.
"""
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main():
    from deepqlearning_tpu import Chain, Dense, DQNConfig, SimpleGridWorld
    from deepqlearning_tpu.models.chain import LSTM
    from deepqlearning_tpu.learner.actor import init_actor
    from deepqlearning_tpu.learner.loop import LoopCarry, build_loop
    from deepqlearning_tpu.replay.episode import EpisodeReplayBuffer
    from deepqlearning_tpu.solver.exploration import LinearDecaySchedule
    from deepqlearning_tpu.utils.compile_cache import enable_compile_cache
    from deepqlearning_tpu.utils.profiling import (
        gpu_name_and_power_limit,
        require_gpu,
        time_calls,
    )

    dev = require_gpu()
    enable_compile_cache()
    num_envs = int(os.environ.get("BENCH_ENVS", "65536"))
    batch_size = 512
    trace_length = 8
    train_freq = 4096
    n_iters = int(os.environ.get("BENCH_ITERS", "50"))
    reps = int(os.environ.get("BENCH_REPS", "10"))

    env = SimpleGridWorld()
    network = Chain(LSTM(2, 32), Dense(32, env.num_actions))
    cfg = DQNConfig(
        num_envs=num_envs, batch_size=batch_size, buffer_size=4096,
        train_freq=train_freq, trace_length=trace_length,
        max_episode_length=100, recurrence=True, double_q=True,
    )
    buffer = EpisodeReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size, trace_length,
        cfg.max_episode_length, num_envs=num_envs,
    )
    iteration, populate_step, optimizer = build_loop(
        env, network, buffer, cfg, LinearDecaySchedule(1.0, 0.01, 100_000),
        gamma=env.discount,
    )

    key = jax.random.PRNGKey(0)
    k_init, k_act, k_learn = jax.random.split(key, 3)
    params = network.init(k_init)
    carry = LoopCarry(
        actor=init_actor(env, network, num_envs, k_act),
        replay=buffer.init(), params=params,
        target_params=params,
        opt_state=optimizer.init(params), lkey=k_learn,
        loss=jnp.asarray(0.0), gnorm=jnp.asarray(0.0),
        sync_acc=jnp.asarray(0, jnp.int32),
    )

    @jax.jit
    def populate(carry):
        # every env must commit at least one episode before sampling
        # (max_episode_length+1 lockstep steps), as in _solve_functional
        actor, replay, params = carry.actor, carry.replay, carry.params
        (actor, replay, params), _ = jax.lax.scan(
            populate_step, (actor, replay, params), None,
            length=cfg.max_episode_length + 1,
        )
        replay = buffer.reset_in_progress(replay)
        return carry._replace(actor=actor, replay=replay)

    @jax.jit
    def run(carry):
        carry, _ = jax.lax.scan(iteration, carry, None, length=n_iters)
        return carry

    carry, secs = time_calls(run, populate(carry), reps)
    steps = n_iters * cfg.env_steps_per_iter
    rates = sorted(steps / s for s in secs)
    q = statistics.quantiles(rates, n=4)
    print(json.dumps({
        "metric": "drqn_env_steps_per_s",
        "value": statistics.median(rates),
        "q1": q[0], "q3": q[2],
        "unit": "steps/s",
        "reps": reps, "iters_per_rep": n_iters,
        "config": f"{num_envs} envs, LSTM32, trace {trace_length}",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": gpu_name_and_power_limit(),
    }))


if __name__ == "__main__":
    main()
