"""Array sum-tree for proportional prioritized sampling, fully on-device.

The reference samples with an O(N) linear weighted draw
(``StatsBase.sample`` with ``Weights``, ``src/prioritized_experience_replay.jl:85``)
which cannot scale; SURVEY.md §2.2 mandates a tree/prefix-sum sampler.

Representation: a tuple of per-level arrays, leaves first, with a **fat
branching factor** (64 by default) — a 256K-leaf tree is 3 levels instead of
18. Each level is a dependent step of the descent (a latency chain), and each
descended level materializes one-hot selection intermediates (memory traffic
∝ draws × stripe width), so fewer, wider levels cost less; a fat node trades
a vectorized cumsum over 64 children for that. Contiguous leaf updates are
``dynamic_update_slice`` writes, not scatters.

All ops are batched, jit-friendly; no host sync, no data-dependent shapes.
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

Tree = Tuple[jnp.ndarray, ...]

BRANCH = 64


def tree_capacity(n: int) -> int:
    """Round up to the next power of two (leaf count)."""
    cap = 1
    while cap < n:
        cap *= 2
    return cap


def _level_sizes(cap: int) -> List[int]:
    sizes = [cap]
    while sizes[-1] > 1:
        size = sizes[-1]
        bf = BRANCH if size % BRANCH == 0 and size >= BRANCH else size
        sizes.append(size // bf)
    return sizes


def init_tree(capacity: int) -> Tree:
    cap = tree_capacity(capacity)
    return tuple(jnp.zeros((s,), jnp.float32) for s in _level_sizes(cap))


def _rebuild_from(leaves: jnp.ndarray) -> Tree:
    levels = [leaves]
    level = leaves
    while level.shape[0] > 1:
        size = level.shape[0]
        bf = BRANCH if size % BRANCH == 0 and size >= BRANCH else size
        level = level.reshape(-1, bf).sum(axis=1)
        levels.append(level)
    return tuple(levels)


def set_priorities(tree: Tree, indices: jnp.ndarray, priorities: jnp.ndarray) -> Tree:
    """Set leaf priorities at arbitrary ``indices`` (scatter) and rebuild.
    Out-of-range indices are dropped."""
    leaves = tree[0].at[indices].set(priorities.astype(jnp.float32),
                                     mode="drop")
    return _rebuild_from(leaves)


def set_priorities_slice(tree: Tree, start, priorities: jnp.ndarray) -> Tree:
    """Set a contiguous run of leaves starting at ``start`` (one slice write) and
    rebuild. Used by the aligned ring insert."""
    leaves = jax.lax.dynamic_update_slice(
        tree[0], priorities.astype(jnp.float32), (start,)
    )
    return _rebuild_from(leaves)


def total(tree: Tree) -> jnp.ndarray:
    return tree[-1][0]


def get_leaf(tree: Tree, indices: jnp.ndarray) -> jnp.ndarray:
    return tree[0][indices]


def _fetch_children(child_level: jnp.ndarray, idx: jnp.ndarray, P: int,
                    bf: int) -> jnp.ndarray:
    """``child_level.reshape(P, bf)[idx]`` without a gather.

    Single one-hot matmul for small parent counts; for large P, a two-stage
    select (stripe of ``P2`` sibling blocks, then block within the stripe)
    keeps the one-hot intermediates at O(B·P/P2 + B·P2·bf) instead of O(B·P).
    """
    B = idx.shape[0]
    hi = jax.lax.Precision.HIGHEST
    blocks = child_level.reshape(P, bf)
    if P <= 1024:
        oh = jax.nn.one_hot(idx, P, dtype=jnp.float32)           # [B, P]
        return jnp.matmul(oh, blocks, precision=hi)
    # split so the two intermediates balance: per-draw elements =
    # P1 (oh1) + P2*bf (stripe row); minimized at P1 = sqrt(P*bf)
    P1 = 1
    while P1 * P1 < P * bf:
        P1 *= 2
    P1 = min(P1, P)
    P2 = P // P1
    oh1 = jax.nn.one_hot(idx // P2, P1, dtype=jnp.float32)      # [B, P1]
    stripes = jnp.matmul(
        oh1, blocks.reshape(P1, P2 * bf), precision=hi
    ).reshape(B, P2, bf)                                         # [B, P2, bf]
    oh2 = jax.nn.one_hot(idx % P2, P2, dtype=jnp.float32)       # [B, P2]
    return jnp.einsum("bp,bpf->bf", oh2, stripes, precision=hi)


def sample(tree: Tree, key, batch_size: int, stratified: bool = True):
    """Draw ``batch_size`` leaf indices proportional to leaf priority.

    Stratified sampling (one uniform draw per equal-mass stratum) is the
    standard PER variant at scale; the reference draws *without replacement*
    (``src/prioritized_experience_replay.jl:85``) which has no fixed-shape
    batched analog — documented deviation (SURVEY.md §7 hard part (a)).

    Descent per level: fetch each sample's ``bf`` children ([B, bf]) as a
    one-hot matmul against the level reshaped to [parents, bf] (at HIGHEST
    precision, so the fetched masses are exact) rather than a per-element
    gather. Then prefix-sum across children and pick the first whose
    cumulative mass exceeds the residual.

    Returns ``(indices [B] int32, priorities [B] float32)``.
    """
    u = jax.random.uniform(key, (batch_size,))
    if stratified:
        u = (jnp.arange(batch_size, dtype=jnp.float32) + u) / batch_size
    mass = u * total(tree)
    idx, _ = descend(tree, mass)
    return idx, tree[0][idx]


def descend(tree: Tree, mass: jnp.ndarray):
    """Descend given target masses; returns ``(leaf idx [B] int32,
    residual mass [B])``. Monotone non-decreasing in ``mass``."""
    batch_size = mass.shape[0]
    idx = jnp.zeros((batch_size,), jnp.int32)
    # descend from just below the root down to the leaves; at each step we sit
    # on a node of `parent_level` and choose among its bf children in `child_level`
    pairs = list(zip(tree[:-1], tree[1:]))  # (child_level, parent_level), leaves up
    for child_level, parent_level in reversed(pairs):
        P = parent_level.shape[0]
        bf = child_level.shape[0] // P
        children = _fetch_children(child_level, idx, P, bf)      # [B, bf]
        csum = jnp.cumsum(children, axis=1)
        j = jnp.sum(mass[:, None] >= csum, axis=1).astype(jnp.int32)
        j = jnp.minimum(j, bf - 1)
        prev = jnp.where(
            j > 0,
            jnp.take_along_axis(csum, jnp.maximum(j - 1, 0)[:, None], axis=1)[:, 0],
            0.0,
        )
        mass = mass - prev
        idx = idx * bf + j
    return idx, mass


def sample_without_replacement(tree: Tree, key, batch_size: int):
    """Weighted sampling *without* replacement — the reference's exact
    semantics (``src/prioritized_experience_replay.jl:85``) via the
    Gumbel-top-k trick: ``argtop_k(log p_i + Gumbel_i)`` is distributed as
    successive proportional draws without replacement (Vieira 2014).

    One [N]-wide elementwise pass + ``top_k`` instead of a tree descent —
    O(N) work but fully vectorized; fine as an opt-in parity/ablation mode,
    not the default at 256K+ leaves. Empty slots carry priority 0 →
    ``log 0 = -inf`` → never selected while any filled slot remains.

    Returns ``(indices [B] int32, priorities [B] float32)``.
    """
    leaves = tree[0]
    g = jax.random.gumbel(key, leaves.shape, jnp.float32)
    scores = jnp.where(leaves > 0, jnp.log(leaves) + g, -jnp.inf)
    _, idx = jax.lax.top_k(scores, batch_size)
    idx = idx.astype(jnp.int32)
    return idx, leaves[idx]
