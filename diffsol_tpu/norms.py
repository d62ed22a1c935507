"""Scaled error norms.

The reference error norm (reference crates/diffsol-la/src/vector/mod.rs:199-212,
nalgebra_serial.rs:330-343) is the squared WRMS norm

    ||x||^2 = (1/n) * sum_i ( x_i / (|y_i| * rtol + atol_i) )^2

For batched (ensemble-lockstep) vectors the reference reduces the mean over
states per batch member, then takes the MAX across batch members so every
member shares one adaptive step (vector/mod.rs tests:756-775).

Layout note: lockstep state "vectors" are 2-D arrays (n, nbatch) --
the ensemble axis last and contiguous -- so every elementwise solver op is fully vectorized with no reshapes.  The
norm reduces mean over the states axis (-2) and max over members and any
extra leading axes (e.g. sensitivity rows).
"""

from __future__ import annotations

import jax.numpy as jnp


def squared_norm(x, y, atol, rtol, nbatch: int = 1):
    """Squared WRMS norm of ``x`` scaled by ``|y|*rtol + atol``.

    With ``nbatch > 1`` the inputs are 2-D lockstep arrays (..., n, nbatch):
    mean over the states axis (-2), max over members and any extra leading
    axes.  Returns a scalar (or a vmap-batched scalar).
    """
    scale = jnp.abs(y) * rtol + atol
    term = x / scale
    sq = term * term
    per_batch = jnp.mean(sq, axis=-2 if nbatch > 1 else -1)
    return jnp.max(per_batch)


def norm(x, y, atol, rtol, nbatch: int = 1):
    """WRMS norm (square root of :func:`squared_norm`)."""
    return jnp.sqrt(squared_norm(x, y, atol, rtol, nbatch))


def squared_norm_and_worst(x, y, atol, rtol, nbatch: int = 1):
    """(squared WRMS norm, index of the dominating lockstep member).

    Shares one scale/term/mean pass between the error test and the
    ``stats.worst_member`` diagnostic (the per-member reduction is the
    same array either way).  Lockstep semantics are shared-fate -- one
    member's error controls the whole batch and a diverging member fails
    it; the returned index names THAT member (for the STATE error rows:
    when quadrature/sensitivity rows dominate the combined error test the
    state-dominant member is reported).  Index 0 when ``nbatch == 1``.
    """
    scale = jnp.abs(y) * rtol + atol
    term = x / scale
    sq = term * term
    per_batch = jnp.mean(sq, axis=-2 if nbatch > 1 else -1)
    if nbatch <= 1:
        return jnp.max(per_batch), jnp.asarray(0, jnp.int32)
    flat = per_batch
    # reduce any extra leading axes (augmented/sensitivity rows) by max
    while flat.ndim > 1:
        flat = jnp.max(flat, axis=0)
    return jnp.max(per_batch), jnp.argmax(flat).astype(jnp.int32)


def worst_member(x, y, atol, rtol, nbatch: int = 1):
    """Index half of :func:`squared_norm_and_worst`."""
    return squared_norm_and_worst(x, y, atol, rtol, nbatch)[1]
