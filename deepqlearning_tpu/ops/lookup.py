"""Small-table lookups as one-hot matmuls.

``take0(table, idx)`` computes ``table[idx]`` for a small ``table`` as a
one-hot ``[N, K]`` matrix times the table: elementwise work plus one
matrix product, with no gather. Its cost grows linearly in K, so it is meant
for small tables only. Whether it beats a plain gather depends on the
backend; it is kept as the exact, precision-pinned reference form.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def take0(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``table[idx]`` along axis 0 via one-hot matmul (gather-free).

    ``table``: [K, ...] with small K. ``idx``: int array, any shape.
    Returns ``idx.shape + table.shape[1:]`` with ``table``'s dtype.
    Float accumulation is exact for values representable in f32 (all int32
    tables with |v| < 2^24, and any f32 table).
    """
    K = table.shape[0]
    tail = table.shape[1:]
    flat_idx = idx.reshape(-1)
    oh = jax.nn.one_hot(flat_idx, K, dtype=jnp.float32)     # [N, K]
    flat_tab = table.reshape(K, -1).astype(jnp.float32)     # [K, P]
    # HIGHEST precision: single-pass bf16 would round table values even
    # against an exact 0/1 one-hot operand
    out = jnp.matmul(oh, flat_tab,
                     precision=jax.lax.Precision.HIGHEST)   # [N, P]
    out = out.reshape(idx.shape + tail)
    if jnp.issubdtype(table.dtype, jnp.integer) or table.dtype == jnp.bool_:
        out = jnp.round(out)
    return out.astype(table.dtype)
