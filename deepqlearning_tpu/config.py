"""Solver configuration.

Field-for-field parity with the reference solver config struct
(``DeepQLearningSolver`` at reference ``src/solver.jl:1-28``), plus
extensions (vectorized env count, dtype, mesh axis names).

Notes on defaults vs the reference:

* ``prioritized_replay_epsilon`` defaults to ``1e-3`` here. The reference
  declares a solver field with default ``1e-6`` (``src/solver.jl:18``) but
  never passes it to the buffer (``src/solver.jl:186``), so the *effective*
  value in the reference is the buffer constructor default ``1e-3``
  (``src/prioritized_experience_replay.jl:45``). We wire the solver field
  through properly and default it to the reference's effective value.
* ``num_envs`` is new: the reference steps exactly one environment
  (``src/solver.jl:82-99``); we step ``num_envs`` in lockstep under ``vmap``.
  All frequencies (``train_freq``, ``eval_freq``, ``target_update_freq``,
  ``log_freq``, ``save_freq``) remain measured in *aggregate env steps* so the
  data/update ratios match the reference (SURVEY.md §7 hard part (c)).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    # --- reference parity fields (src/solver.jl:1-28) ---
    learning_rate: float = 1e-4
    max_steps: int = 1000
    batch_size: int = 32
    train_freq: int = 4
    eval_freq: int = 500
    target_update_freq: int = 500
    num_ep_eval: int = 100
    double_q: bool = True
    dueling: bool = True
    recurrence: bool = False
    trace_length: int = 40
    prioritized_replay: bool = True
    prioritized_replay_alpha: float = 0.6
    prioritized_replay_beta: float = 0.4
    prioritized_replay_epsilon: float = 1e-3
    # "stratified" (O(log N) sum-tree descent, with replacement — default) or
    # "without_replacement" (reference draw semantics via Gumbel-top-k, O(N);
    # src/prioritized_experience_replay.jl:85)
    prioritized_sample_mode: str = "stratified"
    buffer_size: int = 1000
    max_episode_length: int = 100
    train_start: int = 200
    seed: int = 0
    logdir: Optional[str] = "log/"
    save_freq: int = 3000
    log_freq: int = 100
    verbose: bool = True

    # --- extensions over the reference ---
    num_envs: int = 1
    dtype: Any = jnp.float32
    # When several train updates run back-to-back per iteration
    # (updates_per_iter > 1), share one replay sample + priority update
    # across them (see learner/train_step.py::make_grouped_dqn_train_step;
    # deviation documented in docs/DEVIATIONS.md). No effect when
    # updates_per_iter == 1.
    grouped_updates: bool = True
    # Name of the data-parallel mesh axis when running under shard_map/pjit.
    data_axis: str = "data"

    def __post_init__(self):
        # canonicalize dtype so string spellings ('float32') and np/jnp types
        # compare equal everywhere
        object.__setattr__(self, "dtype", jnp.dtype(self.dtype))
        # num_envs and train_freq must nest one way or the other, else the
        # floor-divisions in steps_per_iter/updates_per_iter silently shift
        # the data/update ratio the reference treats as load-bearing
        # (SURVEY.md §7(c)): e.g. num_envs=3, train_freq=4 would train every
        # 3 aggregate steps, not 4.
        if self.num_envs % self.train_freq and self.train_freq % self.num_envs:
            raise ValueError(
                f"num_envs ({self.num_envs}) and train_freq "
                f"({self.train_freq}) must divide one another so the "
                "data/update ratio is exact; pick train_freq a multiple of "
                "num_envs (train less often than every lockstep step) or "
                "num_envs a multiple of train_freq (grouped updates)"
            )

    def replace(self, **kw) -> "DQNConfig":
        return dataclasses.replace(self, **kw)

    @property
    def steps_per_iter(self) -> int:
        """Env steps (per env) collected between consecutive train updates."""
        return max(1, self.train_freq // self.num_envs)

    @property
    def updates_per_iter(self) -> int:
        """Train updates performed after each collect phase."""
        return max(1, (self.num_envs * self.steps_per_iter) // self.train_freq)

    @property
    def env_steps_per_iter(self) -> int:
        """Aggregate env steps per (collect, train) iteration."""
        return self.num_envs * self.steps_per_iter
