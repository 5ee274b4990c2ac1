"""The reference README example (README.md:34-50 there), vectorized.

SimpleGridWorld + MLP Q-network + prioritized double dueling DQN, 10k steps.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from deepqlearning_tpu import (
    Chain,
    DeepQLearningSolver,
    Dense,
    EpsGreedyPolicy,
    LinearDecaySchedule,
    SimpleGridWorld,
)

mdp = SimpleGridWorld()
model = Chain(Dense(2, 32), Dense(32, mdp.num_actions))
exploration = EpsGreedyPolicy(LinearDecaySchedule(start=1.0, stop=0.01, steps=10000 // 2))

solver = DeepQLearningSolver(
    qnetwork=model, max_steps=10000,
    exploration_policy=exploration,
    learning_rate=0.005, log_freq=500,
    recurrence=False, double_q=True, dueling=True, prioritized_replay=True,
)
policy = solver.solve(mdp)

# deploy: greedy rollout
import jax

from deepqlearning_tpu.solver.evaluation import basic_evaluation

r, steps, _ = basic_evaluation(policy.network, policy.params, mdp, 1, 30,
                               jax.random.PRNGKey(0))
print(f"Total undiscounted reward for 1 simulation: {r}")
print("action at (1,1):", policy.action(jnp.asarray([1.0, 1.0])))
