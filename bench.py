"""Benchmark: aggregate env-steps/s of the full actor-learner loop on one GPU.

Headline config: SimpleGridWorld, 131072 vectorized envs, prioritized
sum-tree replay + IS weights, dueling double-DQN learner — the complete loop
(ε-greedy act → vmapped env step → batched PER insert → stratified sum-tree
sample → TD update → priority update) fully jitted. The buffer scales with
the env count (>= 8 insert generations) so replay freshness matches the
reference-style ratios at any size; the data/update ratio is fixed at 4096
env steps per update.

Each rep runs ``BENCH_ITERS`` loop iterations in one jitted scan and ends in
``jax.block_until_ready`` on the whole carry. Prints ONE JSON line: the
median env-steps/s over ``BENCH_REPS`` reps, its quartiles, the device and
the card's name and power limit. Needs an NVIDIA GPU; fails without one.

Run: ``python bench.py`` (``BENCH_ENVS``, ``BENCH_ITERS``, ``BENCH_REPS``).
"""
import json
import os
import statistics

import jax
import jax.numpy as jnp


def main():
    from deepqlearning_tpu import (
        Chain,
        Dense,
        DQNConfig,
        Flatten,
        SimpleGridWorld,
        create_dueling_network,
    )
    from deepqlearning_tpu.learner.actor import init_actor
    from deepqlearning_tpu.learner.loop import LoopCarry, build_loop
    from deepqlearning_tpu.replay.prioritized import PrioritizedReplayBuffer
    from deepqlearning_tpu.solver.exploration import LinearDecaySchedule
    from deepqlearning_tpu.utils.compile_cache import enable_compile_cache
    from deepqlearning_tpu.utils.profiling import (
        gpu_name_and_power_limit,
        require_gpu,
        time_calls,
    )

    dev = require_gpu()
    enable_compile_cache()
    num_envs = int(os.environ.get("BENCH_ENVS", "131072"))
    # hold at least 8 insert generations (and at least 2^18 transitions) so
    # prioritized replay stays meaningful at any env count
    buffer_size = 1 << max(18, (8 * num_envs - 1).bit_length())
    batch_size = 512
    # data/update ratio fixed at 4096 env steps per update regardless of env
    # count (reference-style ratios, SURVEY.md §7(c))
    train_freq = 4096
    n_iters = int(os.environ.get("BENCH_ITERS", "50"))
    reps = int(os.environ.get("BENCH_REPS", "10"))

    env = SimpleGridWorld()
    chain = Chain(Flatten(), Dense(2, 64, jnp.tanh), Dense(64, 64, jnp.tanh),
                  Dense(64, env.num_actions))
    network = create_dueling_network(chain)
    cfg = DQNConfig(
        num_envs=num_envs, batch_size=batch_size, buffer_size=buffer_size,
        train_freq=train_freq,
        max_episode_length=100, double_q=True, dueling=True,
        prioritized_replay=True,
    )
    buffer = PrioritizedReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size,
        alpha=cfg.prioritized_replay_alpha, beta=cfg.prioritized_replay_beta,
        eps=cfg.prioritized_replay_epsilon, prioritized=True,
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
        actor, replay, params = carry.actor, carry.replay, carry.params
        (actor, replay, params), _ = jax.lax.scan(
            populate_step, (actor, replay, params), None, length=2
        )
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
        "metric": "env_steps_per_s",
        "value": statistics.median(rates),
        "q1": q[0], "q3": q[2],
        "unit": "steps/s",
        "reps": reps, "iters_per_rep": n_iters,
        "config": (f"{num_envs} envs, dueling DDQN 2-64-64-4, PER, batch "
                   f"{batch_size}, {cfg.updates_per_iter} updates/iter"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": gpu_name_and_power_limit(),
    }))


if __name__ == "__main__":
    main()
