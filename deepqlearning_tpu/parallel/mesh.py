"""Data-parallel actor-learner over a device mesh.

The reference is strictly single-device (SURVEY.md §2.3); the scaling story
here is the BASELINE.json north star: envs and replay sharded over a
``data`` mesh axis, parameters replicated, gradients ``pmean``-reduced by
XLA — expressed with ``jax.shard_map`` around the same pure
``iteration`` the single-chip solver uses (``learner/loop.py``). Each shard
owns ``num_envs`` local envs and a full local replay shard, so collection and
sampling need *zero* collectives; the only cross-device traffic is the grad
all-reduce (and the scalar metrics).

Cross-slice (DCN) story (VERDICT r4 next-step #4): pass a 2-D
``(dcn, ici)`` mesh (``parallel.multihost.hybrid_mesh``) and the gradient
reduction becomes explicitly hierarchical — ``psum`` over ICI inside each
slice, then one ``psum`` of the already-reduced vector across DCN
(``learner/train_step.py::pmean_flat`` with a tuple axis). For DCN links
too slow for per-update sync, ``dcn_sync_every=k`` switches to local-SGD
semantics: gradients reduce over ICI only, and parameters (plus Adam
moments) are averaged across slices every k iterations — a DOCUMENTED
semantic change (slices drift between syncs; docs/DEVIATIONS.md item 14).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DQNConfig
from ..learner.actor import init_actor
from ..learner.loop import LoopCarry, build_loop
from ..learner.train_step import pmean_flat


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


class DataParallelRunner:
    """Runs the DQN loop with per-device env/replay shards.

    State layout: every leaf of the carry gets leading device axes matching
    the mesh grid (the classic pmap pattern); ``shard_map`` hands each
    device its slice. Parameters start replicated and stay bit-identical
    because the grad reduction makes every device apply the same update.

    ``cfg.num_envs`` is interpreted *per device*; aggregate env throughput is
    ``num_envs * D``.

    Mesh shapes:
      * 1-D ``(data,)`` — flat all-reduce (``pod_data_mesh`` flattens a pod
        ICI-major so XLA still lowers it hierarchically);
      * 2-D ``(dcn, ici)`` — explicit hierarchical ``psum(psum(g, ici),
        dcn)`` per update, or local-SGD with ``dcn_sync_every=k > 1``.
    """

    def __init__(self, env, network, buffer, cfg: DQNConfig, eps_fn,
                 gamma: float, mesh: Optional[Mesh] = None,
                 dcn_sync_every: int = 1):
        self.env, self.network, self.buffer, self.cfg = env, network, buffer, cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axes = tuple(self.mesh.axis_names)
        self.grid_shape = tuple(self.mesh.devices.shape)
        self.n_devices = int(self.mesh.devices.size)
        self.dcn_sync_every = int(dcn_sync_every)
        if self.dcn_sync_every > 1 and len(self.axes) != 2:
            raise ValueError(
                "dcn_sync_every > 1 needs a 2-D (dcn, ici) mesh "
                "(parallel.multihost.hybrid_mesh)"
            )
        if len(self.axes) == 1:
            grad_axis = self.axes[0]
        elif self.dcn_sync_every > 1:
            # local-SGD: per-update grads reduce over ICI only; params +
            # optimizer moments average across DCN every k iterations
            grad_axis = self.axes[1]
        else:
            # hierarchical per-update reduction, innermost (ICI) first
            grad_axis = (self.axes[1], self.axes[0])
        iteration, populate_step, self.optimizer = build_loop(
            env, network, buffer, cfg, eps_fn, gamma, axis_name=grad_axis
        )
        self._iteration = iteration
        self._populate_step = populate_step
        nax = len(self.axes)
        unstack = lambda x: x[(0,) * nax]
        restack = lambda x: x[(None,) * nax]
        dcn_axis = self.axes[0]
        k_sync = self.dcn_sync_every

        def local_segment(stacked_carry, n_iters):
            carry = jax.tree_util.tree_map(unstack, stacked_carry)
            if k_sync > 1:
                def body(carry, i):
                    carry, _ = iteration(carry, None)

                    def sync(c):
                        params = pmean_flat(c.params, dcn_axis)
                        opt_state = jax.tree_util.tree_map(
                            lambda x: jax.lax.pmean(x, dcn_axis)
                            if jnp.issubdtype(x.dtype, jnp.floating) else x,
                            c.opt_state,
                        )
                        return c._replace(params=params, opt_state=opt_state)

                    carry = jax.lax.cond(
                        (i + 1) % k_sync == 0, sync, lambda c: c, carry
                    )
                    return carry, None

                carry, _ = jax.lax.scan(
                    body, carry, jnp.arange(n_iters), length=n_iters
                )
            else:
                carry, _ = jax.lax.scan(iteration, carry, None, length=n_iters)
            return jax.tree_util.tree_map(restack, carry)

        def local_populate(stacked_carry, n_iters):
            carry = jax.tree_util.tree_map(unstack, stacked_carry)
            actor, replay, params = carry.actor, carry.replay, carry.params
            (actor, replay, params), _ = jax.lax.scan(
                populate_step, (actor, replay, params), None, length=n_iters
            )
            carry = carry._replace(actor=actor, replay=replay)
            return jax.tree_util.tree_map(restack, carry)

        spec = P(*self.axes)

        def make_sharded(fn):
            # check_vma off: pmean-derived metrics become device-invariant
            # mid-scan, which the varying-axes checker rejects even though the
            # program is correct (classic pmap-style replication).
            @functools.partial(jax.jit, static_argnums=(1,))
            def run(stacked_carry, n_iters):
                return jax.shard_map(
                    functools.partial(fn, n_iters=n_iters),
                    mesh=self.mesh,
                    in_specs=(spec,),
                    out_specs=spec,
                    check_vma=False,
                )(stacked_carry)

            return run

        self.run_segment = make_sharded(local_segment)
        self.run_populate = make_sharded(local_populate)

    # ------------------------------------------------------------------
    def init_carry(self, key) -> LoopCarry:
        cfg, D, grid = self.cfg, self.n_devices, self.grid_shape
        k_init, k_act, k_learn = jax.random.split(key, 3)
        params = self.network.init(k_init)
        opt_state = self.optimizer.init(params)
        actor_keys = jax.random.split(k_act, D)
        actors = jax.vmap(
            lambda k: init_actor(self.env, self.network, cfg.num_envs, k)
        )(actor_keys)
        replay = self.buffer.init()

        def grid_lead(x):
            """[D, ...] -> grid + [...] leading axes."""
            return x.reshape(grid + x.shape[1:])

        def stack(x):
            return jnp.broadcast_to(x[(None,) * len(grid)], grid + x.shape)

        return LoopCarry(
            actor=jax.tree_util.tree_map(grid_lead, actors),
            replay=jax.tree_util.tree_map(stack, replay),
            params=jax.tree_util.tree_map(stack, params),
            target_params=jax.tree_util.tree_map(stack, params),
            opt_state=jax.tree_util.tree_map(stack, opt_state),
            lkey=grid_lead(jax.random.split(k_learn, D)),
            loss=jnp.zeros(grid),
            gnorm=jnp.zeros(grid),
            sync_acc=jnp.zeros(grid, jnp.int32),
        )

    def device_get_params(self, carry: LoopCarry):
        """Replicated params → single copy (device 0's)."""
        lead = (0,) * len(self.grid_shape)
        return jax.tree_util.tree_map(lambda x: x[lead], carry.params)
