"""Phase-level timing of the headline bench loop on one GPU.

Times the REAL iteration at bench shapes and DCE-proof variants of its two
phases (collect-only / train-only). Every timed function returns the full
carry and each call ends in ``jax.block_until_ready`` on all of it —
returning a scalar would let XLA dead-code-eliminate the replay writes and
the train math. Per-iteration figures are the median over reps divided by
the iterations in one call. Needs an NVIDIA GPU; fails without one.

Run: ``python scripts/profile_bench.py`` (``PROF_ENVS``, ``PROF_LOGC``,
``PROF_ITERS``, ``PROF_REPS``).
"""
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main():
    from deepqlearning_tpu import (
        Chain, Dense, DQNConfig, Flatten, SimpleGridWorld,
        create_dueling_network,
    )
    from deepqlearning_tpu.learner.actor import init_actor, make_collect_step
    from deepqlearning_tpu.learner.loop import LoopCarry, build_loop
    from deepqlearning_tpu.learner.train_step import (
        make_dqn_train_step,
        make_grouped_dqn_train_step,
    )
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
    E = int(os.environ.get("PROF_ENVS", "32768"))
    C = 1 << int(os.environ.get("PROF_LOGC", "18"))
    B, TRAIN_FREQ = 512, 4096
    N_ITERS = int(os.environ.get("PROF_ITERS", "50"))
    REPS = int(os.environ.get("PROF_REPS", "10"))

    env = SimpleGridWorld()
    chain = Chain(Flatten(), Dense(2, 64, jnp.tanh), Dense(64, 64, jnp.tanh),
                  Dense(64, env.num_actions))
    network = create_dueling_network(chain)
    cfg = DQNConfig(
        num_envs=E, batch_size=B, buffer_size=C, train_freq=TRAIN_FREQ,
        max_episode_length=100, double_q=True, dueling=True,
        prioritized_replay=True,
    )
    buffer = PrioritizedReplayBuffer(
        env.obs_shape, C, B, alpha=cfg.prioritized_replay_alpha,
        beta=cfg.prioritized_replay_beta, eps=cfg.prioritized_replay_epsilon,
        prioritized=True,
    )
    eps = LinearDecaySchedule(1.0, 0.01, 100_000)
    iteration, populate_step, optimizer = build_loop(
        env, network, buffer, cfg, eps, gamma=env.discount)

    k_init, k_act, k_learn = jax.random.split(jax.random.PRNGKey(0), 3)
    params = network.init(k_init)
    carry0 = LoopCarry(
        actor=init_actor(env, network, E, k_act), replay=buffer.init(),
        params=params, target_params=params,
        opt_state=optimizer.init(params), lkey=k_learn,
        loss=jnp.asarray(0.0), gnorm=jnp.asarray(0.0),
        sync_acc=jnp.asarray(0, jnp.int32),
    )

    @jax.jit
    def populate(carry):
        actor, replay, params = carry.actor, carry.replay, carry.params
        (actor, replay, params), _ = jax.lax.scan(
            populate_step, (actor, replay, params), None, length=2)
        return carry._replace(actor=actor, replay=replay)

    carry0 = jax.block_until_ready(populate(carry0))
    U, STEPS = cfg.updates_per_iter, cfg.steps_per_iter
    print(f"card: {gpu_name_and_power_limit()}")
    print(f"E={E} steps_per_iter={STEPS} updates_per_iter={U} "
          f"env_steps_per_iter={cfg.env_steps_per_iter}")

    def timed(name, fn, per_unit=1.0):
        _, secs = time_calls(fn, carry0, REPS)
        per = statistics.median(secs) / N_ITERS
        print(f"{name:24s} {per * 1e6:9.1f} us/iter  "
              f"{per / per_unit * 1e6:9.2f} us/unit")
        return per

    @jax.jit
    def full(carry):
        carry, _ = jax.lax.scan(iteration, carry, None, length=N_ITERS)
        return carry

    collect_step = make_collect_step(
        env, network, cfg.max_episode_length, eps,
        lambda r, tr, e: buffer.insert(r, tr))

    @jax.jit
    def collect_only(carry):
        (actor, replay, params), _ = jax.lax.scan(
            collect_step, (carry.actor, carry.replay, carry.params), None,
            length=N_ITERS * STEPS)
        return carry._replace(actor=actor, replay=replay)

    def train_only(ts, opt, length):
        @jax.jit
        def run(carry):
            def body(c, _):
                params, target_params, opt_state, replay, lkey = c
                lkey, k = jax.random.split(lkey)
                res = ts(params, target_params, opt_state, replay, k)
                return (res.params, target_params, res.opt_state,
                        res.replay_state, lkey), None

            init = (carry.params, carry.target_params,
                    opt.init(carry.params), carry.replay, carry.lkey)
            (p, _, o, r, k), _ = jax.lax.scan(body, init, None, length=length)
            return carry._replace(params=p, opt_state=o, replay=r, lkey=k)
        return run

    t_full = timed("full iteration", full)
    t_collect = timed("collect+insert only", collect_only, per_unit=STEPS)
    ts, opt = make_dqn_train_step(network, buffer, env.discount,
                                  cfg.double_q, cfg.learning_rate)
    t_train = timed("train updates only", train_only(ts, opt, N_ITERS * U),
                    per_unit=U)
    ts, opt = make_grouped_dqn_train_step(network, buffer, env.discount,
                                          cfg.double_q, cfg.learning_rate, U)
    t_grouped = timed("train grouped (1 call)", train_only(ts, opt, N_ITERS))

    print(f"\nper iteration ({cfg.env_steps_per_iter} env steps):")
    print(f"  collect : {t_collect*1e6:8.1f} us ({t_collect/t_full*100:5.1f}%)")
    print(f"  train   : {t_train*1e6:8.1f} us ({t_train/t_full*100:5.1f}%) "
          "[sequential]")
    print(f"  grouped : {t_grouped*1e6:8.1f} us ({t_grouped/t_full*100:5.1f}%)"
          " [as in loop]")
    print(f"  implied steps/s: {cfg.env_steps_per_iter / t_full:.4g}")


if __name__ == "__main__":
    main()
