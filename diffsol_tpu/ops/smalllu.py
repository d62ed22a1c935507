"""Batched small-matrix dense LU with partial pivoting, in pure jnp.

Replaces XLA's LuDecomposition custom call for the solver hot path: for
the small systems ODE solvers factorize (n = 2..~40, batched over
10k-member ensembles), an unrolled elimination compiles to straight-line
batched code with no dynamic control flow.  Whether it beats the library
LU at each (n, B) on the GPU is not measured yet.

This is the equivalent of the reference's dense LU backends
(reference crates/diffsol-la/src/linear_solver/nalgebra/lu.rs, faer/lu.rs,
cuda/lu.rs -- the latter loops cuSOLVER getrf over the batch; here the batch
is a vectorized leading axis).

The factorization is ``(lu, perm)`` with ``perm`` the row-permutation index
vector (applied to the RHS at solve time); batch dims broadcast.
"""

from __future__ import annotations

import jax.numpy as jnp

MAX_UNROLL_N = 48  # beyond this, fall back to jax.scipy (see linsol)


def lu_factor(a):
    """LU factorization with partial pivoting of a (..., n, n) matrix.

    Unrolled over the (static) dimension n; batched over leading dims.
    Returns (lu, perm) with L (unit diag) and U packed in ``lu`` and
    ``perm`` (..., n) int32 row-permutation indices.
    """
    n = a.shape[-1]
    batch = a.shape[:-2]
    lu = a
    perm = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), batch + (n,))
    rows = jnp.arange(n, dtype=jnp.int32)
    for k in range(n - 1):
        mag = jnp.abs(lu[..., k:, k])  # (..., n-k)
        pk = (k + jnp.argmax(mag, axis=-1)).astype(jnp.int32)  # (...,)
        # row swap k <-> pk as an index map applied to lu rows and perm
        pk_b = pk[..., None]
        swap = jnp.where(rows == k, pk_b, jnp.where(rows == pk_b, k, rows))
        lu = jnp.take_along_axis(lu, swap[..., None] * jnp.ones((n,), jnp.int32), axis=-2)
        perm = jnp.take_along_axis(perm, swap, axis=-1)
        pivot = lu[..., k, k]
        inv_p = 1.0 / pivot
        l = lu[..., k + 1 :, k] * inv_p[..., None]
        lu = lu.at[..., k + 1 :, k].set(l)
        lu = lu.at[..., k + 1 :, k + 1 :].add(
            -l[..., :, None] * lu[..., k : k + 1, k + 1 :]
        )
    return lu, perm


def lu_solve(factors, b):
    """Solve A x = b given :func:`lu_factor` output; b is (..., n).

    Batch dims of ``b`` broadcast against those of the factors (e.g. one
    factorization shared by nparams sensitivity right-hand sides).
    """
    lu, perm = factors
    n = lu.shape[-1]
    # broadcast b against factor batch dims, then apply the permutation
    if perm.ndim == 1:
        x = b[..., perm]
    else:
        bb = jnp.broadcast_to(b, jnp.broadcast_shapes(b.shape, perm.shape))
        pp = jnp.broadcast_to(perm, bb.shape)
        x = jnp.take_along_axis(bb, pp, axis=-1)
    # forward substitution (L unit lower)
    xs = [x[..., 0]]
    for i in range(1, n):
        acc = x[..., i]
        for j in range(i):
            acc = acc - lu[..., i, j] * xs[j]
        xs.append(acc)
    # back substitution (U upper)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        acc = xs[i]
        for j in range(i + 1, n):
            acc = acc - lu[..., i, j] * out[j]
        out[i] = acc / lu[..., i, i]
    return jnp.stack(out, axis=-1)


# --------------------------------------------------------------------------
# batch-last variant for species-major lockstep ensembles
# --------------------------------------------------------------------------
#
# The batch-last layout (n, n, B) keeps the huge ensemble axis last and
# contiguous and the tiny matrix dims as leading axes, so every scalar of
# the elimination is one contiguous vector across the members.  Pivoting
# is done with where/select masks (no gathers).


def lu_factor_batch_last(a):
    """LU with partial pivoting of (n, n, ...) matrices, batch dims LAST.

    Row swaps are realized as masked selects over the (...,) batch lanes.
    Returns (lu, perm) with perm (n, ...) int32.
    """
    n = a.shape[0]
    batch = a.shape[2:]
    lu = a
    perm = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32).reshape((n,) + (1,) * len(batch)),
        (n,) + batch,
    )
    for k in range(n - 1):
        # per-batch pivot row index among rows k..n-1
        mags = jnp.stack([jnp.abs(lu[i, k]) for i in range(k, n)])  # (n-k, ...)
        pk = k + jnp.argmax(mags, axis=0).astype(jnp.int32)  # (...,)
        # swap rows k <-> pk with masked selects
        new_rows = []
        for i in range(n):
            if i < k:
                new_rows.append(lu[i])
                continue
            take_from_pk = i == k  # row k receives row pk
            row = lu[i]
            if take_from_pk:
                sel = lu[k]
                for j in range(k, n):
                    sel = jnp.where(pk == j, lu[j], sel)
                row = sel
            else:
                # row i receives row k where pk == i
                row = jnp.where(pk == i, lu[k], row)
            new_rows.append(row)
        lu = jnp.stack(new_rows)
        pnew = []
        for i in range(n):
            if i < k:
                pnew.append(perm[i])
            elif i == k:
                sel = perm[k]
                for j in range(k, n):
                    sel = jnp.where(pk == j, perm[j], sel)
                pnew.append(sel)
            else:
                pnew.append(jnp.where(pk == i, perm[k], perm[i]))
        perm = jnp.stack(pnew)
        inv_p = 1.0 / lu[k, k]
        l_rows = [lu[i, k] * inv_p for i in range(k + 1, n)]
        lu = lu.at[k + 1 :, k].set(jnp.stack(l_rows))
        upd = jnp.stack(l_rows)[:, None] * lu[k : k + 1, k + 1 :]
        lu = lu.at[k + 1 :, k + 1 :].add(-upd)
    return lu, perm


def lu_solve_batch_last(factors, b):
    """Solve with batch-last factors; b is (n, ...)."""
    lu, perm = factors
    n = lu.shape[0]
    # apply permutation: x_i = b[perm_i] via masked selects
    xs = []
    for i in range(n):
        sel = b[0]
        for j in range(n):
            sel = jnp.where(perm[i] == j, b[j], sel)
        xs.append(sel)
    # forward substitution
    for i in range(1, n):
        acc = xs[i]
        for j in range(i):
            acc = acc - lu[i, j] * xs[j]
        xs[i] = acc
    # back substitution
    out = [None] * n
    for i in range(n - 1, -1, -1):
        acc = xs[i]
        for j in range(i + 1, n):
            acc = acc - lu[i, j] * out[j]
        out[i] = acc / lu[i, i]
    return jnp.stack(out)
