"""Full-solve benchmark harness — parity with the reference's
``benchmark/flux_dqn.jl:1-51``: time complete 10k-step solves of PER-DDQN and
DRQN over a sweep of observation shapes (5,5), (5,5,5), (20,20), (200,).

Run: ``python benchmark/full_solve.py [--small]``. Prints one JSON line per
(config, obsdim) with wall time, final greedy return and the device it ran on.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from deepqlearning_tpu import (
    Chain,
    DeepQLearningSolver,
    Dense,
    EpsGreedyPolicy,
    Flatten,
    LinearDecaySchedule,
    LSTM,
    TestMDP,
)
from deepqlearning_tpu.solver.evaluation import basic_evaluation
from deepqlearning_tpu.utils.compile_cache import enable_compile_cache


def bench_prioritized_ddqn(obsdim, max_steps):
    mdp = TestMDP(obsdim, 4, 6)
    n_in = 1
    for d in obsdim:
        n_in *= d
    model = Chain(Flatten(), Dense(n_in * 4, 32), Dense(32, mdp.num_actions))
    solver = DeepQLearningSolver(
        qnetwork=model, max_steps=max_steps, learning_rate=0.005,
        eval_freq=2000, num_ep_eval=100, log_freq=15000, verbose=False,
        logdir=None, double_q=True, dueling=True, prioritized_replay=True,
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.01, max_steps // 2)),
    )
    policy = solver.solve(mdp)
    r, _, _ = basic_evaluation(policy.network, policy.params, mdp, 100, 100,
                               jax.random.PRNGKey(1))
    return r


def bench_drqn(obsdim, max_steps):
    mdp = TestMDP(obsdim, 1, 6)
    n_in = 1
    for d in obsdim:
        n_in *= d
    model = Chain(Flatten(), LSTM(n_in, 32), Dense(32, mdp.num_actions))
    solver = DeepQLearningSolver(
        qnetwork=model, max_steps=max_steps, learning_rate=0.005,
        eval_freq=2000, num_ep_eval=100, trace_length=10, log_freq=15000,
        verbose=False, logdir=None, double_q=True, dueling=False,
        recurrence=True,
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.01, max_steps // 2)),
    )
    policy = solver.solve(mdp)
    r, _, _ = basic_evaluation(policy.network, policy.params, mdp, 100, 100,
                               jax.random.PRNGKey(1))
    return r


def main():
    enable_compile_cache()
    small = "--small" in sys.argv
    max_steps = 2000 if small else 10_000
    obsdims = [(5, 5)] if small else [(5, 5), (5, 5, 5), (20, 20), (200,)]
    for obsdim in obsdims:
        for name, fn in [("prioritized_ddqn", bench_prioritized_ddqn),
                         ("drqn", bench_drqn)]:
            t0 = time.perf_counter()
            r = fn(obsdim, max_steps)
            dt = time.perf_counter() - t0
            dev = jax.devices()[0]
            print(json.dumps({
                "bench": name, "obsdim": list(obsdim),
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "max_steps": max_steps,
                "wall_s": round(dt, 2), "final_return": round(float(r), 3),
            }))


if __name__ == "__main__":
    main()
