"""Prioritized (and uniform) experience replay living entirely in HBM.

The reference buffer (``src/prioritized_experience_replay.jl``) is a host-side
ring of Julia structs with O(N) weighted sampling. Here the buffer is a pytree
of fixed-shape device arrays: batched ring insert is one scatter, sampling is
a batched O(log N) sum-tree descent (``ops/sumtree.py``), priority updates are
a scatter + tree rebuild — everything inside ``jit``, nothing touches the
host.

Math parity with the reference:
  * priority at insert = ``(|r| + eps)^alpha``  (``add_exp!`` with td=|r|,
    ``src/solver.jl:92`` + ``src/prioritized_experience_replay.jl:67``)
  * priority at update = ``(|td| + eps)^alpha`` (``:77``)
  * IS weights = ``(N * p/total)^(-beta)``      (``:101-102``), *not*
    max-normalized, matching the reference exactly.
  * uniform replay = constant priorities, no updates, unit weights — the
    reference implements non-prioritized replay the same way
    (priority ``(0+eps)^alpha`` at insert, ``src/solver.jl:94``).

Deviation (documented, SURVEY.md §7(a)): default sampling is stratified
with-replacement instead of weighted without-replacement; pass
``sample_mode="without_replacement"`` for the reference's exact draw
semantics (Gumbel-top-k, O(N)). ``scripts/per_ablation.py`` A/Bs the two
on the learning test matrix.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops import sumtree
from .transition import TransitionBatch


class ReplayState(NamedTuple):
    """Device-resident replay buffer state (a pytree; carry it through jit).

    Transitions are stored as ONE merged row per slot (r5) — obs, next_obs
    and the four f32 scalars (action, reward, done, pad) share a single
    ``[C, 2*prod(obs) + 4*ratio]`` array in the storage dtype, scalars
    bit-cast into dtype lanes (exact f32 round-trip; ``ratio = 4 /
    itemsize``). Sampling a batch is then ONE row gather instead of one per
    field.

    Rows are FLAT rather than ``[C, 2, *obs_shape]`` so that each gathered
    row is one contiguous run whatever the trailing obs dim (e.g. NHWC
    channels=4); the reshape back to obs_shape happens after the gather.
    """

    rows: jnp.ndarray      # [C, 2*no + 4*ratio] obs_dtype (see above)
    tree: jnp.ndarray      # per-level sum-tree tuple (leaves = cap2 >= C)
    insert_pos: jnp.ndarray  # int32 scalar
    size: jnp.ndarray        # int32 scalar


class PrioritizedReplayBuffer:
    """Static descriptor + pure ops for a PER buffer.

    ``alpha=0`` together with ``prioritized=False`` gives uniform replay with
    unit IS weights (reference behavior for ``prioritized_replay=false``).
    """

    def __init__(
        self,
        obs_shape: Tuple[int, ...],
        max_size: int,
        batch_size: int,
        alpha: float = 0.6,
        beta: float = 0.4,
        eps: float = 1e-3,
        prioritized: bool = True,
        obs_dtype=jnp.float32,
        sample_mode: str = "stratified",
    ):
        self.obs_shape = tuple(obs_shape)
        self.no = 1
        for s in self.obs_shape:
            self.no *= int(s)
        self.max_size = int(max_size)
        self.batch_size = int(batch_size)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.eps = float(eps)
        self.prioritized = bool(prioritized)
        self.obs_dtype = jnp.dtype(obs_dtype)
        if self.obs_dtype.itemsize not in (1, 2, 4):
            raise ValueError(
                f"obs_dtype must be a 1/2/4-byte dtype, got {self.obs_dtype}"
            )
        # f32 scalars bit-cast into 4*ratio storage-dtype lanes (16 B exact)
        self.ratio = 4 // self.obs_dtype.itemsize
        if sample_mode not in ("stratified", "without_replacement"):
            raise ValueError(
                f"sample_mode must be 'stratified' or 'without_replacement', "
                f"got {sample_mode!r}"
            )
        if sample_mode == "without_replacement" and self.batch_size > self.max_size:
            # each per-batch Gumbel-top-k pass draws batch_size distinct
            # leaves; more draws than leaves is unsatisfiable (the reference's
            # StatsBase draw errors on k > N too)
            raise ValueError(
                f"without_replacement sampling needs batch_size "
                f"({self.batch_size}) <= buffer max_size ({self.max_size})"
            )
        # "without_replacement" reproduces the reference's exact draw
        # semantics (src/prioritized_experience_replay.jl:85) via
        # Gumbel-top-k — O(N) per sample, opt-in for parity/ablation;
        # "stratified" is the O(log N) sum-tree descent (default).
        self.sample_mode = sample_mode

    # ------------------------------------------------------------------
    def init(self) -> ReplayState:
        C = self.max_size
        return ReplayState(
            rows=jnp.zeros((C, 2 * self.no + 4 * self.ratio), self.obs_dtype),
            tree=sumtree.init_tree(C),
            insert_pos=jnp.asarray(0, jnp.int32),
            size=jnp.asarray(0, jnp.int32),
        )

    def _pack(self, batch: TransitionBatch):
        """Merge a transition batch into storage rows (see ReplayState)."""
        E = batch.action.shape[0]
        scalars = jnp.stack(
            [batch.action.astype(jnp.float32), batch.reward.astype(jnp.float32),
             batch.done.astype(jnp.float32), jnp.zeros((E,), jnp.float32)],
            axis=1,
        )                                                      # [E, 4] f32
        if self.ratio > 1:
            scalars = jax.lax.bitcast_convert_type(
                scalars, self.obs_dtype).reshape(E, 4 * self.ratio)
        else:
            scalars = scalars.astype(self.obs_dtype)
        return jnp.concatenate(
            [batch.obs.reshape(E, self.no).astype(self.obs_dtype),
             batch.next_obs.reshape(E, self.no).astype(self.obs_dtype),
             scalars],
            axis=1,
        )                                                      # [E, 2no+4r]

    def _unpack_scalars(self, sc: jnp.ndarray) -> jnp.ndarray:
        """[..., 4*ratio] storage lanes -> [..., 4] f32 (exact)."""
        if self.ratio > 1:
            return jax.lax.bitcast_convert_type(
                sc.reshape(sc.shape[:-1] + (4, self.ratio)), jnp.float32)
        return sc.astype(jnp.float32)

    def peek_scalars(self, state: ReplayState) -> jnp.ndarray:
        """Decode all slots' (action, reward, done, pad) as [C, 4] f32 —
        test/diagnostic helper."""
        return self._unpack_scalars(state.rows[:, 2 * self.no:])

    def _initial_priority(self, reward: jnp.ndarray) -> jnp.ndarray:
        if self.prioritized:
            return (jnp.abs(reward) + self.eps) ** self.alpha
        return jnp.full_like(reward, self.eps**self.alpha)

    def insert(self, state: ReplayState, batch: TransitionBatch) -> ReplayState:
        """Ring-insert a batch of E transitions.

        When E divides the capacity, ``insert_pos`` stays E-aligned forever,
        so the insert is a contiguous ``dynamic_update_slice`` per field
        instead of a scatter. Misaligned batch sizes fall back to scatter
        with wraparound.
        """
        E = batch.action.shape[0]
        prio = self._initial_priority(batch.reward)
        rows = self._pack(batch)
        if self.max_size % E == 0:
            pos = state.insert_pos
            return ReplayState(
                rows=jax.lax.dynamic_update_slice(
                    state.rows, rows, (pos, jnp.asarray(0, jnp.int32))
                ),
                tree=sumtree.set_priorities_slice(state.tree, pos, prio),
                insert_pos=(state.insert_pos + E) % self.max_size,
                size=jnp.minimum(state.size + E, self.max_size),
            )
        idx = (state.insert_pos + jnp.arange(E, dtype=jnp.int32)) % self.max_size
        return ReplayState(
            rows=state.rows.at[idx].set(rows),
            tree=sumtree.set_priorities(state.tree, idx, prio),
            insert_pos=(state.insert_pos + E) % self.max_size,
            size=jnp.minimum(state.size + E, self.max_size),
        )

    def sample(self, state: ReplayState, key):
        """Sample a batch; returns (TransitionBatch, indices, is_weights)."""
        return self.sample_n(state, key, 1)

    def sample_n(self, state: ReplayState, key, n_batches: int):
        """Draw ``n_batches * batch_size`` transitions in ONE tree descent.

        Used by the grouped train step: at high env counts several updates
        run back-to-back per iteration, and sharing a single stratified
        descent + row gather amortizes the latency-bound sampling chain
        across them.

        Ordering contract: the flat ``[n*B]`` arrays are **u-major** — draws
        for sub-batch ``u`` occupy ``[u*B:(u+1)*B]``, so callers split with a
        free ``reshape(n, B)`` instead of a strided de-interleave (which
        relayouts the whole [nB, *obs] gather output). Stratification is preserved: sub-batch u gets stratified
        draws {u, n+u, 2n+u, ...}, spanning the full priority mass.

        The observation arrays keep the buffer's storage dtype (no forced
        f32 upcast): the network promotes as needed, and a bf16 buffer then
        halves gather + downstream traffic.
        """
        B = self.batch_size
        total_draws = B * n_batches
        if self.sample_mode == "without_replacement":
            # one independent Gumbel-top-k pass PER sub-batch (the reference
            # draws without replacement per batch, with replacement across
            # batches — src/prioritized_experience_replay.jl:85); a single
            # shared pass over all n*B draws would make sub-batches mutually
            # disjoint, a different distribution (ADVICE r2). Pass u IS
            # sub-batch u under the u-major contract.
            # Fill precondition: each pass needs batch_size filled leaves
            # (train_start >= batch_size); draws beyond the filled count get
            # priority 0 and are masked to zero IS weight below, so they
            # contribute nothing rather than training on garbage rows.
            keys = jax.random.split(key, n_batches)
            idx_u, prio_u = jax.vmap(
                lambda k: sumtree.sample_without_replacement(
                    state.tree, k, self.batch_size
                )
            )(keys)  # [n, B]
            idx = idx_u.reshape(-1)
            prio = prio_u.reshape(-1)
        else:
            idx, prio = sumtree.sample(state.tree, key, total_draws)
            if n_batches > 1:
                # stratum-order -> u-major: sub-batch u takes strata
                # {u, n+u, ...}. Reordering the [nB] int32/f32 vectors is
                # free next to the row gather below.
                um = lambda x: jnp.swapaxes(
                    x.reshape(B, n_batches), 0, 1).reshape(-1)
                idx, prio = um(idx), um(prio)
        rows = state.rows[idx]                          # [nB, 2no+4r] — ONE gather
        sc = self._unpack_scalars(rows[:, 2 * self.no:])  # [nB, 4] f32
        oshape = (total_draws,) + self.obs_shape
        batch = TransitionBatch(
            obs=rows[:, : self.no].reshape(oshape),
            action=sc[:, 0].astype(jnp.int32),
            reward=sc[:, 1],
            next_obs=rows[:, self.no: 2 * self.no].reshape(oshape),
            done=sc[:, 2],
        )
        if self.prioritized:
            # guard the degenerate empty-buffer state (total mass 0): the
            # descent then lands on leaf 0 with priority 0 and the IS weight
            # would be 0^(-beta) = inf; clamp those draws to unit weight so a
            # sample-before-populate call degrades to garbage-but-finite
            # (populate-before-train remains the documented contract)
            tot = sumtree.total(state.tree)
            p = prio / jnp.maximum(tot, jnp.float32(1e-30))
            n = jnp.maximum(state.size, 1).astype(jnp.float32)
            # p == 0 handling differs by mode: the stratified descent only
            # lands on a zero leaf when the whole buffer is empty (clamp to
            # unit weight: garbage-but-finite degrade); a without-replacement
            # pass hands out zero-priority UNFILLED slots whenever it runs
            # out of filled leaves — those must get weight 0 so they are
            # silently ignored, not silently trained on (ADVICE r2 medium).
            zero_w = 0.0 if self.sample_mode == "without_replacement" else 1.0
            weights = jnp.where(p > 0, (n * p) ** (-self.beta), zero_w)
        else:
            weights = jnp.ones((total_draws,), jnp.float32)
        return batch, idx, weights

    def update_priorities(
        self, state: ReplayState, indices: jnp.ndarray, td_errors: jnp.ndarray,
    ) -> ReplayState:
        """Parity with ``update_priorities!`` (``src/prioritized_experience_replay.jl:76-80``)."""
        if not self.prioritized:
            return state
        priorities = (jnp.abs(td_errors) + self.eps) ** self.alpha
        # A row drawn more than once keeps its LAST write (the latest
        # sub-update in the grouped step's u-major order), as sequential
        # updates would leave it. XLA's GPU scatter applies duplicate
        # indices in no fixed order, so earlier duplicates are dropped here.
        order = jnp.argsort(indices, stable=True)
        srt = indices[order]
        last = jnp.concatenate([srt[1:] != srt[:-1], jnp.ones((1,), bool)])
        keep = jnp.zeros(indices.shape, bool).at[order].set(last)
        indices = jnp.where(keep, indices, state.tree[0].shape[0])
        return state._replace(
            tree=sumtree.set_priorities(state.tree, indices, priorities)
        )


def ReplayBuffer(obs_shape, max_size, batch_size, obs_dtype=jnp.float32):
    """Uniform replay buffer — PER with constant priorities (reference trick,
    ``src/solver.jl:94``)."""
    return PrioritizedReplayBuffer(
        obs_shape, max_size, batch_size, prioritized=False, obs_dtype=obs_dtype
    )
