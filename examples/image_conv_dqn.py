"""Image-observation DQN through a bf16 conv stack — the compute-bound path.

TestMDP with (20,20) stacked-frame image observations (the reference
benchmark's own sweep shape, ``benchmark/flux_dqn.jl:46-52`` /
``test/test_env.jl:52-58``) solved with a Conv2D Q-network running in bf16.
Demonstrates:

  * `Conv2D` layers + `create_dueling_network` splitting the trailing Dense
    stack into value/advantage heads (the solver does the split when
    ``dueling=True``);
  * bf16 end-to-end: `dtype=jnp.bfloat16` casts network params, and the
    replay buffer stores observations in bf16 (`ops` promote as needed), so
    convs and matmuls run bf16 x bf16 -> f32 (`scripts/conv_bench.py`
    measures this exact shape);
  * vectorized collection with thousands of lockstep envs.

Run: ``python examples/image_conv_dqn.py`` (GPU; ~1 min). CPU works with
``JAX_PLATFORMS=cpu`` but is slow at these sizes — shrink ``num_envs``.
"""
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
    TestMDP,
)
from deepqlearning_tpu.models.chain import Activation, Conv2D

mdp = TestMDP((20, 20), 4, 6)  # obs (20, 20, 4): 4 stacked 20x20 frames
relu = jax.nn.relu
model = Chain(
    Activation(lambda x: x.astype(jnp.bfloat16)),  # bf16 from the input on
    Conv2D(4, 32, (3, 3), (1, 1), "SAME", relu),
    Conv2D(32, 64, (3, 3), (2, 2), "SAME", relu),
    Conv2D(64, 128, (3, 3), (2, 2), "SAME", relu),
    Flatten(),
    Dense(5 * 5 * 128, 512, relu),
    Dense(512, mdp.num_actions),
)

max_steps = 400_000
solver = DeepQLearningSolver(
    qnetwork=model, max_steps=max_steps, num_envs=2048,
    batch_size=512, buffer_size=1 << 15, train_freq=512,
    learning_rate=1e-3, max_episode_length=6,
    double_q=True, dueling=True, prioritized_replay=True,
    target_update_freq=512 * 64,
    eval_freq=max_steps // 8, num_ep_eval=128, log_freq=max_steps // 8,
    dtype=jnp.bfloat16,
    exploration_policy=EpsGreedyPolicy(
        LinearDecaySchedule(1.0, 0.01, max_steps // 2)),
)
policy = solver.solve(mdp)
finals = [r for _, r in solver.metrics["eval"]]
print("eval returns:", [round(float(r), 2) for r in finals])
print("best eval return:", round(max(finals), 2), "(optimum 2.1)")
