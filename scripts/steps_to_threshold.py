"""Steps-to-threshold harness (BASELINE.md primary metric).

Trains the README-config PER-DDQN on SimpleGridWorld and on TestMDP, and
reports the first aggregate env-step count at which the greedy-eval return
crosses the reference thresholds (GridWorld: positive return; TestMDP: 1.5,
reference ``test/runtests.jl:59``). Prints one JSON line per problem.

Run: ``python scripts/steps_to_threshold.py`` (CPU or GPU).
"""
import json
import os
import sys

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
    SimpleGridWorld,
    TestMDP,
)


def steps_to_threshold(name, mdp, model, threshold, max_steps=10_000, **kw):
    solver = DeepQLearningSolver(
        qnetwork=model, max_steps=max_steps, learning_rate=5e-3,
        eval_freq=500, num_ep_eval=100, log_freq=10_000, logdir=None,
        verbose=False, double_q=True, dueling=True, prioritized_replay=True,
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.01, max_steps // 2)
        ),
        **kw,
    )
    solver.solve(mdp)
    crossed = next((t for t, r in solver.metrics["eval"] if r >= threshold), None)
    final = solver.metrics["eval"][-1][1] if solver.metrics["eval"] else None
    print(json.dumps({
        "problem": name,
        "threshold": threshold,
        "steps_to_threshold": crossed,
        "final_eval_return": final,
    }))


def main():
    gw = SimpleGridWorld()
    steps_to_threshold(
        "SimpleGridWorld", gw,
        Chain(Dense(2, 32), Dense(32, gw.num_actions)),
        threshold=1.0,
    )
    tm = TestMDP((5, 5), 4, 6)
    steps_to_threshold(
        "TestMDP(5,5)", tm,
        Chain(Flatten(), Dense(100, 8, jnp.tanh), Dense(8, tm.num_actions)),
        threshold=1.5,
    )


if __name__ == "__main__":
    main()
