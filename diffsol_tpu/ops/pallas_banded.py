"""Pallas kernels (Triton route) for the no-pivot banded LU: factor + solve.

Role of the reference's sparse direct solvers on method-of-lines Jacobians
(reference crates/diffsol-la/src/linear_solver/suitesparse/klu.rs:1-245,
faer/sparse_lu.rs, cuda/lu.rs:59-140).  The XLA formulation in
:mod:`diffsol_tpu.ops.banded` runs a ``fori_loop`` over the n columns with
a ``dynamic_update_slice`` per column; on a GPU every iteration of that
loop is a handful of kernel launches.  Here one Triton program per block of
``BLOCK`` ensemble members runs the whole column loop, so a factorization
or a solve is one launch.

Layout: the lockstep batch-last band ``(nb, n, B)`` (``band[d, j] =
A[j + d - mu, j]``, members last and contiguous).  Every load and store is
one ``(BLOCK,)`` vector across the members of the block at a static band
row and a (dynamic) column, so each lane only ever touches its own member:
the per-member elimination is sequential, the members are the parallel
axis, and nothing is shared between programs (no order between blocks is
assumed).  Members are padded to a multiple of ``BLOCK`` with identity
systems; columns are padded by ``mu`` (unit diagonal) so the update window
never runs off the end, as in the XLA form.

Arithmetic is in the band's own dtype (f64 included).  No pivoting: valid
for the diagonally (semi-)dominant ``M - c*J`` matrices implicit steppers
build from parabolic MOL operators, the same restriction as the XLA form.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# members per program: one warp, one member per lane
BLOCK = 32


def _sync(interpret: bool):
    # the lanes of a block never read each other's members, but a barrier
    # per column keeps the global-memory updates of one column ordered
    # before the next column's loads on every layout Triton may choose
    if not interpret:
        pltriton.debug_barrier()


# Each column step issues its independent loads before the stores that
# depend on them: loads cannot move past a store to the same buffer, so
# grouping them pays one memory latency per group instead of one per entry.


def _factor_kernel(n, ml, mu, interpret, a_ref, o_ref):
    del a_ref  # aliased with o_ref: the factorization runs in place

    def column(k, carry):
        inv = 1.0 / o_ref[mu, k, :]
        ls = [o_ref[mu + i, k, :] * inv for i in range(1, ml + 1)]
        for i in range(1, ml + 1):
            o_ref[mu + i, k, :] = ls[i - 1]
        for dj in range(1, mu + 1):
            # column k+dj: U[k, k+dj] and the entries below it, rows k+1..
            u = o_ref[mu - dj, k + dj, :]
            blk = [o_ref[mu + i - dj, k + dj, :] for i in range(1, ml + 1)]
            for i in range(1, ml + 1):
                o_ref[mu + i - dj, k + dj, :] = blk[i - 1] - ls[i - 1] * u
        _sync(interpret)
        return carry

    jax.lax.fori_loop(0, n, column, 0)


def _solve_kernel(n, ml, mu, interpret, f_ref, b_ref, x_ref):
    del b_ref  # aliased with x_ref: substitution runs in place

    if ml > 0:
        def forward(k, carry):
            xk = x_ref[k, :]
            ls = [f_ref[mu + i, k, :] for i in range(1, ml + 1)]
            xs = [x_ref[k + i, :] for i in range(1, ml + 1)]
            for i in range(1, ml + 1):
                x_ref[k + i, :] = xs[i - 1] - ls[i - 1] * xk
            _sync(interpret)
            return carry

        jax.lax.fori_loop(0, n, forward, 0)

    def backward(j, carry):
        k = n - 1 - j
        acc = x_ref[k, :]
        us = [f_ref[mu - dj, k + dj, :] for dj in range(1, mu + 1)]
        xs = [x_ref[k + dj, :] for dj in range(1, mu + 1)]
        for dj in range(1, mu + 1):
            acc = acc - us[dj - 1] * xs[dj - 1]
        x_ref[k, :] = acc / f_ref[mu, k, :]
        _sync(interpret)
        return carry

    jax.lax.fori_loop(0, n, backward, 0)


def _call(kernel, out_shape, block_shapes, interpret, aliases):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(out_shape.shape[-1] // BLOCK,),
        in_specs=[
            pl.BlockSpec(s, lambda i, r=len(s): (0,) * (r - 1) + (i,))
            for s in block_shapes
        ],
        out_specs=pl.BlockSpec(
            out_shape.shape[:-1] + (BLOCK,),
            lambda i, r=len(out_shape.shape): (0,) * (r - 1) + (i,),
        ),
        input_output_aliases=aliases,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name=kernel.func.__name__.strip("_"),
    )


def _padded_members(nbatch: int) -> int:
    return -(-nbatch // BLOCK) * BLOCK


@functools.partial(jax.jit, static_argnames=("ml", "mu", "interpret"))
def band_lu_factor(band, ml: int, mu: int, interpret: bool = False):
    """Factor a batch-last band array ``(nb, n, B)`` without pivoting.

    Returns the factored band padded to ``(nb, n + mu, B')`` with ``B'``
    the members rounded up to a multiple of :data:`BLOCK`: L multipliers
    below the main-diagonal row ``mu``, U in and above it (LAPACK
    gbtrf-style).  Pass the result to :func:`band_lu_solve`.
    """
    nb, n, nbatch = band.shape
    if nb != ml + mu + 1:
        raise ValueError(f"band has {nb} rows, expected ml+mu+1={ml + mu + 1}")
    bp = _padded_members(nbatch)
    # padded columns and padded members carry a unit diagonal
    ap = jnp.zeros((nb, n + mu, bp), band.dtype).at[mu].set(1.0)
    ap = ap.at[:, :n, :nbatch].set(band)
    kernel = functools.partial(_factor_kernel, n, ml, mu, interpret)
    return _call(
        kernel,
        jax.ShapeDtypeStruct(ap.shape, ap.dtype),
        [ap.shape[:-1] + (BLOCK,)],
        interpret,
        {0: 0},
    )(ap)


@functools.partial(jax.jit, static_argnames=("ml", "mu", "interpret"))
def band_lu_solve(factors, b, ml: int, mu: int, interpret: bool = False):
    """Solve with factors from :func:`band_lu_factor`; ``b`` is (n, B)."""
    n, nbatch = b.shape
    nb, _, bp = factors.shape
    rows = n + max(ml, mu, 1)
    bpad = jnp.zeros((rows, bp), factors.dtype).at[:n, :nbatch].set(b)
    kernel = functools.partial(_solve_kernel, n, ml, mu, interpret)
    x = _call(
        kernel,
        jax.ShapeDtypeStruct(bpad.shape, bpad.dtype),
        [factors.shape[:-1] + (BLOCK,), (rows, BLOCK)],
        interpret,
        {1: 0},
    )(factors, bpad)
    return x[:n, :nbatch]
