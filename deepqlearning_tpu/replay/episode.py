"""Episode replay buffer for recurrent DRQN — time-ring layout, zero scatters
on the hot path, window sampling as ONE sliced gather.

The reference stores whole variable-length episodes and cuts random
``trace_length`` windows at sample time (``src/episode_replay.jl``). A naive
static-shape port (per-env accumulator rows + row scatters on commit) puts
E scatters on every step. Instead, transitions stream into a **time-major
ring** ``[R, E, F]``: every lockstep step writes row ``t % R`` for all envs
— and because the time axis is MAJOR, that row is one contiguous slab
regardless of which layout XLA picks for the sample-time gathers (an
env-major ``[E, R]`` ring lets XLA lay the ring out R-minor, turning the
per-step column write into E scattered stores).

Layout:

  * ALL fields share one ring ``[R + T - 1, E, 2*prod(obs) + 4]``
    (``obs | next_obs | action, reward, done, pad``), so sampling is one
    gather of wide rows instead of one gather per field.
  * The ring carries ``T - 1`` SHADOW rows mirroring rows ``0..T-2`` (each
    step writes its row, and its shadow copy when ``t % R < T-1``), so every
    trace window is a CONTIGUOUS ``[T]`` slice mod-free — sampling becomes a
    single ``lax.gather`` with ``slice_sizes=(T, 1, F)``: U*B indices instead
    of U*B*T row indices.

Episodes are just ``(start, length)`` records in a small per-env index ring,
updated with a one-hot select over the M record columns (scatter-free).
Window semantics match ``src/episode_replay.jl:71-95``: uniform episode,
random start offset, zero-padded ``trace_length`` window with a validity
mask. Records whose data has been overwritten by the ring are remapped to
the env's most recent episode (documented deviation; with default sizing the
ring holds the full episode capacity so this only triggers after wraparound).

Storage dtype: the merged ring is stored in ``obs_dtype`` itself.
Obs/next_obs are cast to ``obs_dtype`` (the usual quantization the caller
asked for); the four f32 scalars (action, reward, done, pad) are **bit-cast**
into ``4 / itemsize(obs_dtype)`` lanes of the ring dtype and bit-cast back at
sample time — exact f32 round-trip, zero precision loss, still ONE gather.
A uint8 image ring is 4x smaller than an all-f32 ring (bf16: 2x), so under
the same ``max_ring_bytes`` cap it holds 4x the history instead of wrapping
early. f32 is the identity case.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .transition import TransitionBatch


class EpisodeBatch(NamedTuple):
    """A batch of trace windows; leading axes are [batch, time]."""

    obs: jnp.ndarray       # [B, T, *obs_shape]
    action: jnp.ndarray    # [B, T] int32
    reward: jnp.ndarray    # [B, T] float32
    next_obs: jnp.ndarray  # [B, T, *obs_shape]
    done: jnp.ndarray      # [B, T] float32
    mask: jnp.ndarray      # [B, T] float32 — 1 for valid steps


class EpisodeReplayState(NamedTuple):
    # streamed transitions: ONE merged time-major ring (dtype = obs_dtype)
    # with T-1 shadow rows (see module docstring); feature layout per env:
    # [obs (no) | next_obs (no) | action, reward, done, pad — the scalars
    #  bit-cast from f32 into 4*ratio lanes of the ring dtype].
    # G = max(1, 128 // F) envs share one 128-wide row, so rows stay dense
    # for small F (no padding of a narrow minor dim) while the window gather
    # still reads whole rows; the sampled window selects its env's F lanes
    # afterwards (an exact elementwise select).
    data: jnp.ndarray      # [R + T - 1, E // G, G * F] obs_dtype
    # episode index: per-env ring of (start, length) records
    ep_start: jnp.ndarray  # [E, M] int32 — global step of episode start
    ep_len: jnp.ndarray    # [E, M] int32
    rec_count: jnp.ndarray  # [E] int32 — total records written per env
    cur_len: jnp.ndarray    # [E] int32 — steps in the in-progress episode
    t: jnp.ndarray          # int32 — global lockstep step counter


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


class EpisodeReplayBuffer:
    def __init__(
        self,
        obs_shape: Tuple[int, ...],
        max_size: int,
        batch_size: int,
        trace_length: int,
        max_episode_length: int,
        num_envs: int = 1,
        obs_dtype=jnp.float32,
        max_ring_bytes: int = 2 << 30,
    ):
        self.obs_shape = tuple(obs_shape)
        self.max_size = int(max_size)          # episode capacity (aggregate)
        self.batch_size = int(batch_size)
        self.trace_length = int(trace_length)
        self.max_episode_length = int(max_episode_length)
        self.num_envs = int(num_envs)
        self.obs_dtype = jnp.dtype(obs_dtype)
        if self.obs_dtype.itemsize not in (1, 2, 4):
            raise ValueError(
                f"obs_dtype must be a 1/2/4-byte dtype, got {self.obs_dtype}"
            )
        self.no = _prod(self.obs_shape)
        # scalars (action, reward, done, pad: 4 x f32) are bit-cast into
        # ring-dtype lanes: 4*ratio lanes of itemsize bytes = 16 bytes exact
        self.ratio = 4 // self.obs_dtype.itemsize
        self.F = 2 * self.no + 4 * self.ratio
        # envs per 128-lane storage row (see EpisodeReplayState.data)
        G = max(1, 128 // self.F)
        while G > 1 and self.num_envs % G:
            G //= 2
        self.G = G
        # per-env episode-record slots; aggregate record capacity >= max_size
        self.records_per_env = max(2, -(-self.max_size // self.num_envs))
        # time ring must hold max_size episodes' worth of steps per env (and
        # at least two max-length episodes so the open episode never bites
        # its own tail)
        self.ring = _pow2(
            max(2 * self.max_episode_length,
                self.records_per_env * self.max_episode_length)
        )
        # memory cap: for image observations at the default
        # buffer_size=1000/num_envs=1 the ring would be 131072 slots/env —
        # GBs. Cap the ring at ``max_ring_bytes`` (stale episode records
        # remap to the env's newest episode, so a smaller ring only means
        # earlier wraparound, not corruption).
        slot_bytes = self.F * self.obs_dtype.itemsize
        min_ring = _pow2(2 * self.max_episode_length)
        while (self.ring > min_ring
               and self.num_envs * self.ring * slot_bytes > max_ring_bytes):
            self.ring //= 2
        total = self.num_envs * self.ring * slot_bytes
        if total > max_ring_bytes:
            raise ValueError(
                f"EpisodeReplayBuffer needs {total / 2**30:.2f} GiB even at "
                f"the minimum ring of 2*max_episode_length steps/env "
                f"({min_ring} slots x {self.num_envs} envs x {slot_bytes} B). "
                "Reduce num_envs, max_episode_length, or the observation "
                "size, or raise max_ring_bytes."
            )

    def init(self) -> EpisodeReplayState:
        E, R, M, T = self.num_envs, self.ring, self.records_per_env, self.trace_length
        return EpisodeReplayState(
            data=jnp.zeros((R + T - 1, E // self.G, self.G * self.F),
                           self.obs_dtype),
            ep_start=jnp.zeros((E, M), jnp.int32),
            ep_len=jnp.zeros((E, M), jnp.int32),
            rec_count=jnp.zeros((E,), jnp.int32),
            cur_len=jnp.zeros((E,), jnp.int32),
            t=jnp.asarray(0, jnp.int32),
        )

    # ------------------------------------------------------------------
    def add_step(
        self, state: EpisodeReplayState, batch: TransitionBatch, ended: jnp.ndarray
    ) -> EpisodeReplayState:
        """Append one lockstep transition per env (one merged slab write, plus
        its shadow copy); envs whose episode ``ended`` commit an index record
        via a one-hot select (scatter-free).

        Analog of ``add_exp!`` + ``add_episode!`` (``src/episode_replay.jl:46-60``).
        """
        E, R, M, T = self.num_envs, self.ring, self.records_per_env, self.trace_length
        k = state.t % R

        scalars = jnp.stack(
            [batch.action.astype(jnp.float32),
             batch.reward.astype(jnp.float32),
             batch.done.astype(jnp.float32),
             jnp.zeros_like(batch.reward, jnp.float32)], axis=1)  # [E, 4]
        if self.ratio > 1:
            # exact f32 -> ring-dtype lane packing (bit-cast, not a cast)
            scalars = jax.lax.bitcast_convert_type(
                scalars, self.obs_dtype).reshape(E, 4 * self.ratio)
        else:
            scalars = scalars.astype(self.obs_dtype)
        row = jnp.concatenate(
            [
                batch.obs.reshape(E, self.no).astype(self.obs_dtype),
                batch.next_obs.reshape(E, self.no).astype(self.obs_dtype),
                scalars,
            ],
            axis=1,
        ).reshape(1, E // self.G, self.G * self.F)  # [1, E/G, G*F]
        zero = jnp.asarray(0, jnp.int32)
        data = jax.lax.dynamic_update_slice(state.data, row, (k, zero, zero))
        # shadow mirror: rows 0..T-2 live again at R..R+T-2 so sample-time
        # windows are contiguous [T] slices; when k >= T-1 this re-writes
        # row k (a harmless duplicate — cheaper than a branch)
        k2 = jnp.where(k < T - 1, R + k, k)
        data = jax.lax.dynamic_update_slice(data, row, (k2, zero, zero))

        ended = ended.astype(jnp.bool_)
        new_len = state.cur_len + 1
        start = state.t - new_len + 1
        # one-hot select over the M record columns: ended envs write record
        # slot rec_count % M; others match no column (slot = M)
        slot = jnp.where(ended, state.rec_count % M, M)
        sel = jnp.arange(M)[None, :] == slot[:, None]          # [E, M]
        ep_start = jnp.where(sel, start[:, None], state.ep_start)
        ep_len = jnp.where(sel, new_len[:, None], state.ep_len)
        return EpisodeReplayState(
            data=data,
            ep_start=ep_start, ep_len=ep_len,
            rec_count=state.rec_count + ended.astype(jnp.int32),
            cur_len=jnp.where(ended, 0, new_len),
            t=state.t + 1,
        )

    def reset_in_progress(self, state: EpisodeReplayState) -> EpisodeReplayState:
        """Drop in-progress episodes (used after the populate phase so the
        training actor's fresh episodes don't concatenate onto them)."""
        return state._replace(cur_len=jnp.zeros_like(state.cur_len))

    # ------------------------------------------------------------------
    @property
    def size_fn(self):
        return lambda state: jnp.sum(
            jnp.minimum(state.rec_count, self.records_per_env)
        )

    def sample(self, state: EpisodeReplayState, key) -> EpisodeBatch:
        """Uniform episodes, random-start windows, zero-padded with mask.

        Semantics of ``sample(::EpisodeReplayBuffer)``
        (``src/episode_replay.jl:71-95``). Stale records (data overwritten by
        the time ring) are remapped to the env's most recent episode.
        """
        return self._sample_batch(state, key, self.batch_size)

    def sample_n(self, state: EpisodeReplayState, key, n_batches: int):
        """Draw ``n_batches * batch_size`` windows in ONE sliced gather.

        The grouped DRQN train step shares a single episode-index draw and
        window gather across its sub-updates (same amortization as
        ``PrioritizedReplayBuffer.sample_n`` — the window gather is the
        latency-bound part). Returns an EpisodeBatch with a flat ``[n * B]``
        leading axis; the caller de-interleaves stride-``n``.
        """
        return self._sample_batch(state, key, self.batch_size * n_batches)

    def _sample_batch(self, state: EpisodeReplayState, key,
                      B: int) -> EpisodeBatch:
        T, R, M, E = (self.trace_length, self.ring,
                      self.records_per_env, self.num_envs)
        k_env, k_rec, k_start = jax.random.split(key, 3)
        # uniform over STORED EPISODES, not over envs: drawing the env
        # uniformly then a record within it oversamples episodes in
        # sparse envs whenever per-env record counts differ (reference
        # draws uniformly over all stored episodes,
        # src/episode_replay.jl:77-80). The weighted env draw rides the
        # sum-tree descent (one-hot stages) instead of a jnp.searchsorted,
        # which lowers to a sequential binary-search chain.
        from ..ops import sumtree

        def weighted_env(k):
            counts = jnp.minimum(state.rec_count, M).astype(jnp.float32)
            Ep = 1
            while Ep < E:
                Ep *= 2
            ctree = sumtree._rebuild_from(jnp.pad(counts, (0, Ep - E)))
            total = jnp.maximum(sumtree.total(ctree), 1.0)
            mass = jax.random.uniform(k, (B,)) * total
            env, _ = sumtree.descend(ctree, mass)
            return jnp.minimum(env, E - 1)

        def uniform_env(k):
            return jax.random.randint(k, (B,), 0, E)

        # once every env's record ring is full the weighted draw IS the
        # uniform draw (all counts == M) — skip the count-tree chain, which
        # costs real latency on the train path (steady state in practice)
        env = jax.lax.cond(
            jnp.min(state.rec_count) >= M, uniform_env, weighted_env, k_env
        )
        n_rec = jnp.maximum(jnp.minimum(state.rec_count[env], M), 1)
        rec = jax.random.randint(k_rec, (B,), 0, jnp.asarray(1 << 30)) % n_rec
        # remap records whose data the ring has overwritten to the most
        # recent record of that env
        start = state.ep_start[env, rec]
        length = state.ep_len[env, rec]
        stale = (state.t - start) > (R - jnp.maximum(length, 1))
        newest = (state.rec_count[env] - 1) % jnp.maximum(n_rec, 1)
        rec = jnp.where(stale, newest, rec)
        start = state.ep_start[env, rec]
        length = jnp.maximum(state.ep_len[env, rec], 1)

        u = jax.random.randint(k_start, (B,), 0, jnp.asarray(1 << 30)) % length
        valid = jnp.arange(T)[None, :] < (length - u)[:, None]   # [B, T]
        mask = valid.astype(jnp.float32)

        # window = T CONTIGUOUS ring rows starting at (start+u) % R (the
        # shadow rows make the wrap-around contiguous): one sliced gather
        # with B indices instead of B*T row indices, reading the env
        # GROUP's aligned [T, G*F] tile; the env's own F lanes are then
        # selected with a one-hot contraction (G*F <= 128, trivial)
        G = self.G
        t0 = (start + u) % R
        idx = jnp.stack([t0, env // G], axis=-1)                 # [B, 2]
        dnums = jax.lax.GatherDimensionNumbers(
            offset_dims=(1, 2, 3),
            collapsed_slice_dims=(),
            start_index_map=(0, 1),
        )
        win = jax.lax.gather(
            state.data, idx, dnums, slice_sizes=(T, 1, G * self.F),
            mode="promise_in_bounds",
        )[:, :, 0]                                               # [B, T, G*F]
        if G > 1:
            # EXACT lane select (where + one-term sum): a one-hot matmul
            # at default precision would round the bit-cast scalar lanes
            # (TF32/bf16 passes) and corrupt the decoded f32s
            sel = (jnp.arange(G)[None, None, :, None]
                   == (env % G)[:, None, None, None])            # [B,1,G,1]
            w4 = win.reshape(B, T, G, self.F)
            acc = (jnp.int32 if jnp.issubdtype(self.obs_dtype, jnp.integer)
                   else jnp.float32)
            win = jnp.sum(
                jnp.where(sel, w4, jnp.zeros((), self.obs_dtype)),
                axis=2, dtype=acc,
            ).astype(self.obs_dtype)                             # [B, T, F]
        no, ratio = self.no, self.ratio
        sc = win[..., 2 * no:]                             # [B, T, 4*ratio]
        if ratio > 1:
            # exact lane unpack back to the four f32 scalars
            sc = jax.lax.bitcast_convert_type(
                sc.reshape(B, T, 4, ratio), jnp.float32)
        else:
            sc = sc.astype(jnp.float32)
        sc = sc * mask[..., None]                          # zero-pad invalid
        zero = jnp.zeros((), self.obs_dtype)
        obs = jnp.where(valid[..., None], win[..., :no], zero)
        nobs = jnp.where(valid[..., None], win[..., no:2 * no], zero)
        oshape = (B, T) + self.obs_shape
        return EpisodeBatch(
            obs=obs.reshape(oshape),
            action=sc[..., 0].astype(jnp.int32),
            reward=sc[..., 1],
            next_obs=nobs.reshape(oshape),
            done=sc[..., 2],
            mask=mask,
        )
