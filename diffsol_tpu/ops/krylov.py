"""Matrix-free Newton-Krylov linear tier (GMRES on JVPs).

The third KLU-role tier (SURVEY §7; reference suitesparse/klu.rs,
faer/sparse_lu.rs): for Jacobians that are neither narrow-banded nor
block-decomposable, the iteration matrix ``A = M - c*J`` is never
materialized -- GMRES solves ``A x = b`` with the operator applied as

    A v = mass_mul(v) - c * jvp(rhs, y)(v)

one rhs-JVP per Krylov iteration: JVPs are elementwise/stencil work, and
no n x n matrix is ever factored in the problem dtype.

Used inside the steppers' frozen-Jacobian Newton: the "factorization" is
the frozen linearization point (t, y, c) plus an optional TRIDIAGONAL
preconditioner extracted with 3 cyclic JVP probes and factored by the
Thomas algorithm -- for diffusion-dominated MOL/battery systems the main
couplings sit near the diagonal, and the preconditioner turns hundreds of
GMRES iterations into a handful.  Inexactness is governed by ``gmres_tol``;
the Newton convergence control measures true-residual progress, so a loose
inner solve degrades the convergence RATE, not the answer (same contract
as the f32 tiers).

Reference role citation: diffsol has no Krylov tier (KLU/faer direct
solvers only) -- this is capability beyond the reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .linsol import DiagMass, LinearSolverSpec


def _tridiag_probes(op, n, dtype):
    """Extract the tridiagonal part of a linear operator with 3 cyclic
    probes: band[d, j] = (A e_{j mod 3})[j + d - 1], d in {0, 1, 2}."""
    idx = jnp.arange(n)

    def probe(c):
        e = jnp.where(idx % 3 == c, 1.0, 0.0).astype(dtype)
        return op(e)

    probes = jax.vmap(probe)(jnp.arange(3))  # (3, n)
    # a[j] = A[j, j-1] (from probe of column j-1), d[j] = A[j, j],
    # c[j] = A[j, j+1] (from probe of column j+1); wider-than-tridiagonal
    # structure aliases into the probes, which only perturbs the
    # PRECONDITIONER, never the GMRES answer
    dmain = probes[idx % 3, idx]
    a_sub = jnp.zeros((n,), dtype).at[1:].set(
        probes[(idx[:-1]) % 3, idx[1:]]
    )  # A[j, j-1]: probe seeding col j-1 read at row j
    c_sup = jnp.zeros((n,), dtype).at[:-1].set(
        probes[(idx[1:]) % 3, idx[:-1]]
    )  # A[j, j+1]
    return a_sub, dmain, c_sup


def _thomas_factor(a, d, c):
    """LU of a tridiagonal system without pivoting (scan over n).

    Pivots are clamped away from zero: the tridiagonal here is only ever a
    PRECONDITIONER (possibly alias-contaminated), and a singular pivot
    would NaN-poison GMRES."""

    def step(carry, x):
        d_prev = carry
        a_j, d_j, c_prev = x
        w = a_j / d_prev
        d_new = d_j - w * c_prev
        d_new = jnp.where(jnp.abs(d_new) < 1e-30, 1.0, d_new)
        return d_new, (w, d_new)

    c_shift = jnp.concatenate([jnp.zeros((1,), d.dtype), c[:-1]])
    _, (w, dd) = jax.lax.scan(step, d[0], (a[1:], d[1:], c_shift[1:]))
    w = jnp.concatenate([jnp.zeros((1,), d.dtype), w])
    dd = jnp.concatenate([d[:1], dd])
    return w, dd, c


def _thomas_solve(factors, b):
    w, dd, c = factors

    def fwd(carry, x):
        b_prev = carry
        b_j, w_j = x
        b_new = b_j - w_j * b_prev
        return b_new, b_new

    _, y = jax.lax.scan(fwd, b[0], (b[1:], w[1:]))
    y = jnp.concatenate([b[:1], y])

    def bwd(carry, x):
        x_next = carry
        y_j, d_j, c_j = x
        x_j = (y_j - c_j * x_next) / d_j
        return x_j, x_j

    _, xs = jax.lax.scan(
        bwd, y[-1] / dd[-1], (y[:-1][::-1], dd[:-1][::-1], c[:-1][::-1])
    )
    return jnp.concatenate([xs[::-1], y[-1:] / dd[-1:]])


def make_krylov_solver(
    rhs,
    *,
    gmres_tol: float = 1e-6,
    restart: int = 30,
    maxiter: int = 10,
    precond: str = "lu32",
    jac_fn=None,
) -> LinearSolverSpec:
    """Matrix-free GMRES tier over ``rhs(t, y, p)``.

    The equations' ``rhs_jac`` must be :func:`make_krylov_jac` (the builder
    installs it): the "Jacobian representation" is the frozen linearization
    point itself.  ``precond``:

    * ``"lu32"`` (default): an f32 LU of the EXACT iteration matrix --
      mixed-precision iterative refinement.  GMRES in the problem dtype recovers full accuracy in a handful of iterations
      (residual contraction ~ eps_f32 * cond(A) per apply).  Costs one
      n-column jacfwd + O(n^3) f32 factor per Jacobian refresh (amortized
      by the steppers' reuse policy) and O(n^2) f32 memory.
    * ``"tridiag"``: 3-probe Thomas preconditioner -- O(n) memory, best
      for diffusion-dominated operators; wider structure aliases into the
      probes and can weaken it badly.
    * ``"none"``: unpreconditioned.

    ``jac_fn`` (optional): a ``(t, y, p) -> (n, n)`` dense-Jacobian
    extractor used by the ``lu32`` preconditioner instead of the default
    n-column ``jax.jacfwd`` -- the builder passes the colored-probe
    extractor (ops/coloring.py) when sparsity was detected, cutting the
    preconditioner assembly from n JVP columns to ncolors probes (the
    program-size lever for ~1000-state DAE programs; reference role: KLU's symbolic analysis reuse,
    suitesparse/klu.rs:60-120).
    """
    if precond not in ("lu32", "tridiag", "none"):
        raise ValueError(f"unknown preconditioner {precond!r}")
    import jax.scipy.linalg as jsl

    def assemble(mass, jac, c):
        # jac is the frozen point (t, y, p) from make_krylov_jac
        t, y, p = jac
        return (mass, t, y, p, jnp.asarray(c))

    def _op(mass, t, y, p, c, v):
        jv = jax.jvp(lambda yy: rhs(t, yy, p), (y,), (v,))[1]
        if mass is None:
            mv = v
        elif isinstance(mass, DiagMass):
            mv = v * mass.d
        else:
            mv = mass @ v
        return mv - c * jv

    def factor(a):
        mass, t, y, p, c = a
        if precond == "none":
            pre = None
        elif precond == "lu32":
            if jac_fn is not None:
                jac32 = jac_fn(t, y, p).astype(jnp.float32)
            else:
                jac32 = jax.jacfwd(lambda yy: rhs(t, yy, p))(y).astype(
                    jnp.float32
                )
            n = y.shape[-1]
            if mass is None:
                m32 = jnp.eye(n, dtype=jnp.float32)
            elif isinstance(mass, DiagMass):
                m32 = jnp.eye(n, dtype=jnp.float32) * mass.d.astype(
                    jnp.float32
                )
            else:
                m32 = mass.astype(jnp.float32)
            pre = jsl.lu_factor(m32 - c.astype(jnp.float32) * jac32)
        else:
            n = y.shape[-1]
            op = functools.partial(_op, mass, t, y, p, c)
            sub, dmain, sup = _tridiag_probes(op, n, y.dtype)
            # guard breakdowns: fall back to the identity row where the
            # tridiagonal pivot vanishes
            dmain = jnp.where(jnp.abs(dmain) < 1e-30, 1.0, dmain)
            pre = _thomas_factor(sub, dmain, sup)
        return (mass, t, y, p, c, pre)

    def solve(factors, b):
        mass, t, y, p, c, pre = factors
        if b.ndim == 2:  # augmented rows (naug, n)
            return jax.vmap(lambda v: solve(factors, v))(b)
        op = functools.partial(_op, mass, t, y, p, c)
        if pre is None:
            M = None
        elif precond == "lu32":
            M = lambda v: jsl.lu_solve(pre, v.astype(jnp.float32)).astype(
                b.dtype
            )
        else:
            M = lambda v: _thomas_solve(pre, v)
        x, _info = jax.scipy.sparse.linalg.gmres(
            op, b, tol=gmres_tol, atol=0.0, restart=restart,
            maxiter=maxiter, M=M, solve_method="batched",
        )
        return x

    def placeholder(n, dtype):
        # never used by the steppers (they assemble real factors at init);
        # the frozen-point structure depends on params, unknowable here
        raise NotImplementedError("krylov tier has no placeholder factors")

    return LinearSolverSpec(
        name=f"krylov({precond})",
        assemble=assemble,
        factor=factor,
        solve=solve,
        placeholder_factors=placeholder,
        # jac_fn rides along so make_lockstep_problem can rebuild the
        # colored-probe preconditioner batch-last when lifting the tier
        meta=(gmres_tol, restart, maxiter, precond, jac_fn),
    )


def make_krylov_solver_lockstep(
    rhs_b,
    nbatch: int,
    *,
    gmres_tol: float = 1e-6,
    restart: int = 30,
    maxiter: int = 10,
    precond: str = "lu32",
    member_jac_fn=None,
) -> LinearSolverSpec:
    """Lockstep (n, B) lift of the matrix-free krylov tier (reference role:
    per-batch factorization under the nbatch context,
    crates/diffsol-la/src/linear_solver/cuda/lu.rs:69-96).

    ``rhs_b`` is the BATCHED rhs ``(t, (n,B), (B,np)) -> (n,B)``.  One
    GMRES iteration runs over the whole (n*B) block system: the member
    blocks are independent, so the joint Krylov space converges like the
    worst member -- exactly the lockstep contract (the error-norm max
    already couples members' step sizes).  The lu32 preconditioner
    factorizes PER MEMBER: ``member_jac_fn`` (a per-member dense extractor,
    e.g. colored probes) is vmapped batch-last and fed to a batched f32
    ``lu_factor`` on (B, n, n).
    """
    if precond not in ("lu32", "none"):
        raise ValueError(
            f"lockstep krylov supports lu32/none preconditioning, got "
            f"{precond!r}"
        )
    import jax.scipy.linalg as jsl

    def assemble(mass, jac, c):
        t, Y, Pb = jac  # frozen point, batch-last state
        return (mass, t, Y, Pb, jnp.asarray(c))

    def _mass_mul(mass, v):
        if mass is None:
            return v
        if isinstance(mass, DiagMass):
            return v * mass.d  # (n, B) diagonal values
        # dense lockstep mass (n, n, B)
        return jnp.einsum("ijb,jb->ib", mass, v)

    def _op(mass, t, Y, Pb, c, v):
        jv = jax.jvp(lambda yy: rhs_b(t, yy, Pb), (Y,), (v,))[1]
        return _mass_mul(mass, v) - c * jv

    def factor(a):
        mass, t, Y, Pb, c = a
        if precond == "none":
            return (mass, t, Y, Pb, c, None)
        n = Y.shape[0]
        if member_jac_fn is not None:
            jac_bl = jax.vmap(
                member_jac_fn, in_axes=(None, 1, 0), out_axes=2
            )(t, Y, Pb)  # (n, n, B)
        else:
            # n column probes of the batched operator (columns broadcast
            # over the member lanes); block-diagonal structure makes each
            # probe exactly one member-Jacobian column
            basis = jnp.eye(n, dtype=Y.dtype)

            def col(e):
                v = jnp.broadcast_to(e[:, None], Y.shape)
                return jax.jvp(lambda yy: rhs_b(t, yy, Pb), (Y,), (v,))[1]

            jac_bl = jnp.moveaxis(jax.vmap(col)(basis), 0, 1)  # (n, n, B)
        jac32 = jnp.moveaxis(jac_bl, 2, 0).astype(jnp.float32)  # (B, n, n)
        if mass is None:
            m32 = jnp.broadcast_to(
                jnp.eye(n, dtype=jnp.float32), jac32.shape
            )
        elif isinstance(mass, DiagMass):
            dvals = jnp.moveaxis(mass.d, 1, 0).astype(jnp.float32)  # (B, n)
            m32 = dvals[:, :, None] * jnp.eye(n, dtype=jnp.float32)
        else:
            m32 = jnp.moveaxis(mass, 2, 0).astype(jnp.float32)
        pre = jsl.lu_factor(m32 - c.astype(jnp.float32) * jac32)
        return (mass, t, Y, Pb, c, pre)

    def solve(factors, b):
        mass, t, Y, Pb, c, pre = factors
        if b.ndim == 3:  # augmented rows (naug, n, B)
            return jax.vmap(lambda v: solve(factors, v))(b)
        op = functools.partial(_op, mass, t, Y, Pb, c)
        if pre is None:
            M = None
        else:
            def M(v):
                vb = jnp.moveaxis(v, 1, 0).astype(jnp.float32)  # (B, n)
                xb = jsl.lu_solve(pre, vb[..., None])[..., 0]
                return jnp.moveaxis(xb, 0, 1).astype(b.dtype)

        x, _info = jax.scipy.sparse.linalg.gmres(
            op, b, tol=gmres_tol, atol=0.0, restart=restart,
            maxiter=maxiter, M=M, solve_method="batched",
        )
        return x

    def placeholder(n, dtype):
        raise NotImplementedError("krylov tier has no placeholder factors")

    return LinearSolverSpec(
        name=f"krylov_lockstep({precond})",
        assemble=assemble,
        factor=factor,
        solve=solve,
        placeholder_factors=placeholder,
        meta=(gmres_tol, restart, maxiter, precond, nbatch),
    )


def make_krylov_jac():
    """The matching ``rhs_jac``: the Jacobian "representation" is the
    frozen linearization point (t, y, p) -- no matrix is ever formed."""

    def jac(t, y, p):
        return (t, y, p)

    jac.jvp_probes = 0  # no probes at jac-eval time (JVPs happen per solve)
    return jac


def make_matfree_residual_solver(residual, gmres_tol: float = 1e-8,
                                 restart: int = 30, maxiter: int = 20):
    """(factorize, solve) pair for Newton on an arbitrary residual F(x)
    without an f64 factorization -- the consistent-IC analog of the krylov
    tier (used by solvers/consistent_ic.py when the problem's linear
    solver is matrix-free).  ``factorize(x)`` freezes the linearization
    point and builds the f32-LU preconditioner of the exact dF/dx;
    ``solve(factors, v)`` runs preconditioned GMRES on the f64 JVP
    operator (mixed-precision iterative refinement).

    2-D lockstep states (n, nb): the member blocks are independent, so n
    column probes (seeds broadcast over the lanes) recover the per-member
    Jacobians exactly; the preconditioner becomes a batched (nb, n, n) f32
    LU and GMRES runs over the joint (n*nb) block system."""
    import jax.scipy.linalg as jsl

    def factorize(x):
        if x.ndim == 2:
            n = x.shape[0]
            basis = jnp.eye(n, dtype=x.dtype)

            def col(e):
                v = jnp.broadcast_to(e[:, None], x.shape)
                return jax.jvp(residual, (x,), (v,))[1]  # (n, nb)

            cols = jax.vmap(col)(basis)  # (col, row, nb)
            jac32 = jnp.transpose(cols, (2, 1, 0)).astype(jnp.float32)
            return (x, jsl.lu_factor(jac32))  # (nb, n, n)
        jac32 = jax.jacfwd(residual)(x).astype(jnp.float32)
        return (x, jsl.lu_factor(jac32))

    def solve(factors, v):
        x0, pre = factors

        def op(w):
            return jax.jvp(residual, (x0,), (w,))[1]

        if v.ndim == 2:
            def M(w):
                wb = jnp.moveaxis(w, 1, 0).astype(jnp.float32)  # (nb, n)
                xb = jsl.lu_solve(pre, wb[..., None])[..., 0]
                return jnp.moveaxis(xb, 0, 1).astype(v.dtype)
        else:
            def M(w):
                return jsl.lu_solve(pre, w.astype(jnp.float32)).astype(
                    v.dtype
                )

        sol, _info = jax.scipy.sparse.linalg.gmres(
            op, v, tol=gmres_tol, atol=0.0, restart=restart,
            maxiter=maxiter, M=M, solve_method="batched",
        )
        return sol

    return factorize, solve
