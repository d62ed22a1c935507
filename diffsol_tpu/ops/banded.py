"""Banded linear-solver tier: no-pivot banded LU + coloring-based Jacobians.

Replacement for the reference's sparse LU backends used on
method-of-lines Jacobians (reference crates/diffsol-la/src/linear_solver/
suitesparse/klu.rs, faer/sparse_lu.rs) and its graph-coloring Jacobian
machinery (crates/diffsol/src/jacobian/: NaN-probe sparsity detection +
greedy coloring).  Banded structure is the common case for MOL PDEs
(heat1d/heat2d-class problems), and a band factorization is O(n*ml*mu)
with fixed shapes, batchable over an ensemble.

* Band storage is column-major LAPACK-style: ``band[d, j] = A[j + d - mu, j]``
  for d in [0, ml+mu], so ``band[mu]`` is the main diagonal.
* The Jacobian is extracted with ml+mu+1 structurally-orthogonal JVP probes
  (cyclic coloring -- the optimal coloring for a banded pattern, replacing
  the reference's greedy graph coloring for this structure).
* Factorization is LU WITHOUT pivoting (valid for the diagonally dominant
  ``M - c*J`` matrices BDF/SDIRK assemble from parabolic MOL operators; the
  reference's KLU pivots, which a fixed-shape band code cannot).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .linsol import LinearSolverSpec


def dense_to_band(a, ml: int, mu: int):
    """Extract the (ml+mu+1, n) band array from a dense (n, n) matrix."""
    n = a.shape[-1]
    nb = ml + mu + 1
    d = np.arange(nb)[:, None]
    j = np.arange(n)[None, :]
    i = j + d - mu
    valid = (i >= 0) & (i < n)
    i_c = np.clip(i, 0, n - 1)
    band = a[..., i_c, j]
    return jnp.where(jnp.asarray(valid), band, 0.0)


def band_to_dense(band, ml: int, mu: int):
    """Expand a (ml+mu+1, n) band array to dense (2-D only; test helper)."""
    n = band.shape[-1]
    out = jnp.zeros((n, n), band.dtype)
    for d in range(ml + mu + 1):
        offset = d - mu  # row - col
        vals = band[d]
        if offset >= 0:
            out = out + jnp.diag(vals[: n - offset] if offset else vals, -offset)
        else:
            out = out + jnp.diag(vals[-offset:], -offset)
    return out


def make_banded_jac(rhs, ml: int, mu: int):
    """Banded Jacobian df/dy via ml+mu+1 cyclically-colored JVP probes.

    Returns a callable (t, y, p) -> (ml+mu+1, n) band array.  Equivalent in
    role to the reference's JacobianColoring::jacobian_inplace
    (jacobian/mod.rs:218-260) specialized to band structure.
    """
    nc = ml + mu + 1

    def jac(t, y, p):
        n = y.shape[-1]
        cols_idx = jnp.arange(n)
        seeds = jax.vmap(
            lambda c: jnp.where(cols_idx % nc == c, 1.0, 0.0).astype(y.dtype)
        )(jnp.arange(nc))

        def probe(v):
            return jax.jvp(lambda yy: rhs(t, yy, p), (y,), (v,))[1]

        probes = jax.vmap(probe)(seeds)  # (nc, n): J @ seed_c
        # band[d, j] = (J e_{j mod nc})[j + d - mu]
        d = np.arange(nc)[:, None]
        j = np.arange(n)[None, :]
        i = j + d - mu
        valid = (i >= 0) & (i < n)
        i_c = np.clip(i, 0, n - 1)
        color = np.asarray(j % nc + np.zeros_like(d))
        band = probes[color, i_c]
        return jnp.where(jnp.asarray(valid), band, 0.0)

    jac.jvp_probes = nc  # OpStatistics jac_mul_evals accounting
    return jac


# --------------------------------------------------------------------------
# factorization / solve
# --------------------------------------------------------------------------


def _band_lu_factor(band, ml: int, mu: int):
    """In-place-style no-pivot banded LU; returns the factored band array
    with L multipliers below the diagonal rows and U above."""
    n = band.shape[-1]
    nb = ml + mu + 1
    dtype = band.dtype
    # pad mu extra columns so the update window never runs off the end;
    # padded columns get unit diagonal
    pad = jnp.zeros(band.shape[:-1] + (mu,), dtype)
    bandp = jnp.concatenate([band, pad], axis=-1)
    bandp = bandp.at[..., mu, n:].set(1.0)

    if ml > 0 and mu > 0:
        di = np.arange(1, ml + 1)[:, None]
        dj = np.arange(1, mu + 1)[None, :]
        upd_rows = np.broadcast_to(mu + di - dj, (ml, mu))  # band row of A[k+di, k+dj]
        u_rows = (mu - np.arange(1, mu + 1))  # band row of A[k, k+dj] in window col dj-1
        upd_cols = np.broadcast_to(dj - 1, (ml, mu))
    else:
        upd_rows = u_rows = upd_cols = None

    def body(k, bp):
        pivot = jax.lax.dynamic_slice_in_dim(bp, k, 1, axis=-1)[..., mu, 0]
        lcol = jax.lax.dynamic_slice_in_dim(bp, k, 1, axis=-1)[..., mu + 1 :, 0]
        l = lcol / pivot[..., None]  # (..., ml)
        # write multipliers back into column k
        colk = jax.lax.dynamic_slice_in_dim(bp, k, 1, axis=-1)
        colk = colk.at[..., mu + 1 :, 0].set(l)
        bp = jax.lax.dynamic_update_slice_in_dim(bp, colk, k, axis=-1)
        if upd_rows is not None:
            w = jax.lax.dynamic_slice_in_dim(bp, k + 1, mu, axis=-1)  # (..., nb, mu)
            u = w[..., u_rows, np.arange(mu)]  # (..., mu) = U[k, k+1..k+mu]
            upd = l[..., :, None] * u[..., None, :]  # (..., ml, mu)
            w = w.at[..., upd_rows, upd_cols].add(-upd)
            bp = jax.lax.dynamic_update_slice_in_dim(bp, w, k + 1, axis=-1)
        return bp

    bandp = jax.lax.fori_loop(0, n, body, bandp)
    return bandp


def _band_lu_solve(bandp, b, ml: int, mu: int):
    """Solve with the factored padded band array from :func:`_band_lu_factor`."""
    n = b.shape[-1]
    dtype = b.dtype
    # forward substitution: b[k+i] -= L[k+i,k] * b[k]
    padf = jnp.zeros(b.shape[:-1] + (ml,), dtype)
    bf = jnp.concatenate([b, padf], axis=-1)

    def fwd(k, bf):
        colk = jax.lax.dynamic_slice_in_dim(bandp, k, 1, axis=-1)
        l = colk[..., mu + 1 :, 0]  # (..., ml)
        bk = jax.lax.dynamic_slice_in_dim(bf, k, 1, axis=-1)[..., 0]
        seg = jax.lax.dynamic_slice_in_dim(bf, k + 1, ml, axis=-1)
        seg = seg - l * bk[..., None]
        return jax.lax.dynamic_update_slice_in_dim(bf, seg, k + 1, axis=-1)

    bf = jax.lax.fori_loop(0, n - 1, fwd, bf) if ml > 0 else bf

    # back substitution: x[k] = (b[k] - sum_dj U[k,k+dj] x[k+dj]) / U[k,k]
    padb = jnp.zeros(b.shape[:-1] + (mu,), dtype)
    x = jnp.concatenate([bf[..., :n], padb], axis=-1)
    u_rows = mu - np.arange(1, mu + 1) if mu > 0 else None

    def bwd(i, x):
        k = n - 1 - i
        diag = jax.lax.dynamic_slice_in_dim(bandp, k, 1, axis=-1)[..., mu, 0]
        acc = jax.lax.dynamic_slice_in_dim(x, k, 1, axis=-1)[..., 0]
        if mu > 0:
            w = jax.lax.dynamic_slice_in_dim(bandp, k + 1, mu, axis=-1)
            u = w[..., u_rows, np.arange(mu)]  # (..., mu)
            xs = jax.lax.dynamic_slice_in_dim(x, k + 1, mu, axis=-1)
            acc = acc - jnp.sum(u * xs, axis=-1)
        xk = (acc / diag)[..., None]
        return jax.lax.dynamic_update_slice_in_dim(x, xk, k, axis=-1)

    x = jax.lax.fori_loop(0, n, bwd, x)
    return x[..., :n]


def make_banded_solver(
    ml: int, mu: int, kernel: str = "auto", interpret: bool = False
) -> LinearSolverSpec:
    """A :class:`LinearSolverSpec` for matrices with bandwidth (ml, mu).

    The matrix representation through assemble/factor is the (ml+mu+1, n)
    band array (batch-last (ml+mu+1, n, B) under lockstep); the equations'
    ``rhs_jac`` must produce this representation (the OdeBuilder installs
    :func:`make_banded_jac` automatically when this tier is selected).

    ``kernel`` selects the factorization backend, both in the problem
    dtype:

    * ``"triton"`` -- one Pallas program per block of ensemble members runs
      the whole column loop (:mod:`diffsol_tpu.ops.pallas_banded`): one
      launch per factorization or solve.  Needs a GPU, or
      ``interpret=True``.
    * ``"xla"`` -- the fori_loop/dynamic-slice formulation above.
    * ``"auto"`` (default) -- ``"triton"`` when the default JAX backend is
      a GPU at spec-construction time (the only backend that compiles the
      kernel), else ``"xla"``.
    """
    if kernel == "auto":
        kernel = "triton" if jax.default_backend() == "gpu" else "xla"
    if kernel not in ("triton", "xla"):
        raise ValueError(
            f"unknown banded kernel {kernel!r} (valid: 'auto', 'triton', 'xla')"
        )

    def assemble(mass, jac_band, c):
        from .linsol import DiagMass

        if mass is None:
            # identity mass: 1.0 on the main-diagonal band row (axis 0 = d)
            m_band = jnp.zeros_like(jac_band).at[mu].set(1.0)
        elif isinstance(mass, DiagMass):
            # diagonal mass: values straight onto the main-diagonal band
            # row -- no dense (n, n[, B]) materialization
            m_band = jnp.zeros_like(jac_band).at[mu].set(mass.d)
        elif mass.ndim == 2 and mass.shape[-1] == mass.shape[-2]:
            m_band = dense_to_band(mass, ml, mu)
            if jac_band.ndim == 3:  # lockstep batch-last: broadcast members
                m_band = m_band[:, :, None]
        elif mass.ndim == 3 and mass.shape[0] == mass.shape[1]:
            # lockstep batch-last dense mass blocks (n, n, B)
            m_band = jnp.moveaxis(
                dense_to_band(jnp.moveaxis(mass, -1, 0), ml, mu), 0, -1
            )
        else:
            m_band = mass
        return m_band - c * jac_band

    if kernel == "triton":
        from . import pallas_banded

        def factor(a_band):
            if a_band.ndim == 2:
                # one system: a one-member block, marked by a leading axis
                f = pallas_banded.band_lu_factor(
                    a_band[:, :, None], ml, mu, interpret=interpret
                )
                return (f[None],)
            return (pallas_banded.band_lu_factor(
                a_band, ml, mu, interpret=interpret
            ),)

        def solve(factors, b):
            f = factors[0]

            def lockstep(v):  # v (n, B)
                return pallas_banded.band_lu_solve(
                    f, v, ml, mu, interpret=interpret
                )

            if f.ndim == 4:  # one system, b is (..., n)
                def one(v):
                    return pallas_banded.band_lu_solve(
                        f[0], v[:, None], ml, mu, interpret=interpret
                    )[:, 0]

                flat = b.reshape(-1, b.shape[-1])
                return jax.vmap(one)(flat).reshape(b.shape)
            if b.ndim == 3:  # augmented rows (naug, n, B)
                return jax.vmap(lockstep)(b)
            return lockstep(b)

        def placeholder(n, dtype):
            return factor(jnp.zeros((ml + mu + 1, n), dtype).at[mu].set(1.0))

    else:

        def factor(a_band):
            if a_band.ndim == 3:
                # lockstep batch-last (nb, n, B) -> batch-leading for the
                # "..." convention of the fori implementation
                return (
                    jnp.moveaxis(
                        _band_lu_factor(jnp.moveaxis(a_band, -1, 0), ml, mu),
                        0, -1,
                    ),
                )
            return (_band_lu_factor(a_band, ml, mu),)

        def solve(factors, b):
            f = factors[0]
            if f.ndim == 3:
                if b.ndim == 3:  # augmented rows (naug, n, B)
                    return jax.vmap(lambda v: solve(factors, v))(b)
                x = _band_lu_solve(
                    jnp.moveaxis(f, -1, 0), jnp.moveaxis(b, -1, 0), ml, mu
                )
                return jnp.moveaxis(x, 0, -1)
            return _band_lu_solve(f, b, ml, mu)

        def placeholder(n, dtype):
            band = jnp.zeros((ml + mu + 1, n), dtype).at[mu, :].set(1.0)
            return (_band_lu_factor(band, ml, mu),)

    return LinearSolverSpec(
        name=f"banded({ml},{mu},{kernel})",
        assemble=assemble,
        factor=factor,
        solve=solve,
        placeholder_factors=placeholder,
        meta=(ml, mu, kernel),
    )
