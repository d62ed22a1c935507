"""Consistent initial conditions for singular-mass DAEs.

Implements the Brown/Hindmarsh/Petzold (1998) approach of the reference
(reference crates/diffsol/src/op/init.rs `InitOp`,
ode_solver/state.rs:84-162 `set_consistent`, diffsol-nl/src/line_search.rs
:110-201 `BacktrackingLineSearch`): algebraic variables are the states with
a zero diagonal in the mass matrix; the unknowns are (du_differential,
v_algebraic) packed into one full-length vector and solved from

    F(x) = f(t0, y|alg<-x) - M_u @ (x|alg<-0) = 0

by damped Newton with an IDA-style Armijo backtracking line search
(tau = 0.5, c = 1e-4, steptol = eps^(2/3)), re-factorizing the Jacobian up
to ``max_linear_solver_setups`` times.  Where the reference assembles the
block Jacobian [[-M_u, df/dv], [0, dg/dv]] by matrix splitting, here it is
simply ``jax.jacfwd`` of the packed residual.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import errors
from ..norms import norm as wrms_norm
from ..ops.newton import CONTINUE, CONVERGED, DIVERGED, ETA_RESET_JACOBIAN


def algebraic_mask(problem, params=None):
    """Static boolean mask of algebraic states (zero mass diagonal);
    reference Matrix::partition_indices_by_zero_diagonal (matrix/mod.rs:195).

    Evaluated eagerly at problem/solver construction time (requires concrete
    params), since the partition determines program structure.
    """
    if problem.eqn.mass is None:
        return None
    params = problem.params if params is None else params
    mass = np.asarray(problem.eqn.mass(problem.t0, params))
    if mass.ndim == 3:  # lockstep-batched mass (n, n, B): partition shared
        mass = mass[:, :, 0]
    diag = np.diag(mass)
    mask = diag == 0.0
    if not mask.any():
        return None
    if problem.lockstep_nbatch > 1:
        # 2-D lockstep state (n, nbatch): broadcast the mask over the lanes
        return jnp.asarray(mask)[:, None]
    return jnp.asarray(mask)


def _blockwise_jacfwd(f, x):
    """Per-member Jacobian of a batch-independent residual.

    For x (..., n) with f acting independently along the batch axes, returns
    (..., n, n) via n basis-vector JVPs broadcast over the batch (avoids the
    (B,n,B,n) tensor a naive jacfwd would build for lockstep ensembles).
    """
    n = x.shape[-1]
    basis = jnp.eye(n, dtype=x.dtype)

    def col(e):
        v = jnp.broadcast_to(e, x.shape)
        return jax.jvp(f, (x,), (v,))[1]

    cols = jax.vmap(col)(basis)  # (n, ..., n_out)
    return jnp.moveaxis(cols, 0, -1)


def make_consistent(problem, params, y, dy, is_alg, t=None):
    """Solve for consistent (y, dy) at time ``t`` (default: problem.t0);
    returns (y, dy, status).

    ``is_alg`` is the static algebraic mask from :func:`algebraic_mask`.
    ``t`` matters for non-autonomous equations (e.g. the adjoint system,
    whose Jacobian tracks the interpolated forward trajectory): resets and
    discrete adjoint jumps re-establish consistency at the CURRENT time,
    not at t0.
    """
    p = problem
    nb = p.lockstep_nbatch
    t0 = jnp.asarray(p.t0 if t is None else t, y.dtype)
    ic = p.ic_options
    dtype = y.dtype
    eps = jnp.finfo(dtype).eps
    tol = jnp.asarray(p.options.nonlinear_solver_tolerance, dtype)
    steptol = eps ** (2.0 / 3.0)
    tau = ic.step_reduction_factor
    armijo_c = ic.armijo_constant
    max_ls = ic.max_linesearch_iterations
    max_newton = ic.max_newton_iterations
    max_setups = ic.max_linear_solver_setups

    y_fixed = y

    def residual(x):
        y0 = jnp.where(is_alg, x, y_fixed)
        f = p.eqn.rhs(t0, y0, params)
        du = jnp.where(is_alg, 0.0, x)
        mdu = p.eqn.mass_mul(t0, params, du)
        mdu = jnp.where(is_alg, 0.0, mdu)
        return f - mdu

    x0 = jnp.where(is_alg, y, dy)

    # factorization of the packed IC Jacobian: flat lockstep problems use
    # block-cyclic JVP probes (n_member probes for any batch size) through
    # the lockstep linear tier; everything else uses a one-off dense LU
    from ..ops import linsol

    spec = p.linear_solver
    if spec.name.startswith("banded"):
        # The packed IC residual inherits the rhs band structure (plus the
        # in-band mass diagonal), so factor it through the problem's banded
        # tier: ml+mu+1 cyclic JVP probes for ANY state size / batch, and no
        # dense O(n^3) LU.
        ml, mu = spec.meta[:2]
        nc = ml + mu + 1
        n_state = y.shape[0]
        import numpy as _np

        d_i = _np.arange(nc)[:, None]
        j_i = _np.arange(n_state)[None, :]
        i_i = j_i + d_i - mu
        valid = jnp.asarray((i_i >= 0) & (i_i < n_state))
        i_c = _np.clip(i_i, 0, n_state - 1)
        color = _np.broadcast_to(j_i % nc, (nc, n_state))

        def factorize(x):
            idx = jnp.arange(n_state)

            def probe(c):
                e = jnp.where(idx % nc == c, 1.0, 0.0).astype(x.dtype)
                v = e if x.ndim == 1 else jnp.broadcast_to(e[:, None], x.shape)
                return jax.jvp(residual, (x,), (v,))[1]

            probes = jax.vmap(probe)(jnp.arange(nc))  # (nc, n[, nb])
            band = probes[color, i_c]  # (nc, n[, nb])
            vmask = valid if band.ndim == 2 else valid[..., None]
            band = jnp.where(vmask, band, 0.0)
            return spec.factor(band)

        def lin_solve_dense(factors, v):
            return spec.solve(factors, v)

    elif spec.name.startswith("krylov"):
        # matrix-free problems keep the IC solve matrix-free too: GMRES on
        # the IC-residual JVP with the 3-probe tridiagonal preconditioner
        from ..ops.krylov import make_matfree_residual_solver

        factorize, lin_solve_dense = make_matfree_residual_solver(residual)

    elif nb > 1:
        # 2-D lockstep state (n, nb): n member probes (column seeds broadcast
        # over the lanes) build the batch-last (n, n, nb) block Jacobian
        from ..ops import smalllu

        n_mem = y.shape[0]

        def factorize(x):
            basis = jnp.eye(n_mem, dtype=x.dtype)

            def col(e):
                v = jnp.broadcast_to(e[:, None], x.shape)
                return jax.jvp(residual, (x,), (v,))[1]  # (n, nb)

            cols = jax.vmap(col)(basis)  # (probe=col, row, nb)
            jac = jnp.moveaxis(cols, 0, 1)  # (row, col, nb)
            return smalllu.lu_factor_batch_last(jac)

        def lin_solve_dense(factors, v):
            return smalllu.lu_solve_batch_last(factors, v)

    else:

        def factorize(x):
            jac = _blockwise_jacfwd(residual, x)
            return linsol.DENSE.factor(jac)

        def lin_solve_dense(factors, v):
            return linsol.DENSE.solve(factors, v)

    def newton_with_linesearch(x, eta):
        """One Newton campaign with a frozen factorization.

        Returns (x, status, eta).  Status follows the reference Convergence
        semantics; line-search failure maps to DIVERGED so the outer loop
        refactorizes and retries.
        """
        factors = factorize(x)
        lin = lambda v: lin_solve_dense(factors, v)
        delta = lin(residual(x))
        nrm = wrms_norm(delta, y_fixed, p.atol, p.rtol, nb)

        def check(niter, nrm, first_norm, eta):
            """Convergence check (convergence.rs:69-130); returns (status, eta)."""
            eta_first = jnp.maximum(eta, 1e4 * eps) ** jnp.asarray(0.8, dtype)
            k = jnp.maximum(niter - 1, 1).astype(dtype)
            rate = (nrm / jnp.maximum(first_norm, 0.0)) ** (1.0 / k)
            rate = jnp.where(jnp.isfinite(rate), rate, jnp.inf)
            proj = (
                rate ** jnp.maximum(max_newton - niter, 0).astype(dtype)
                / (1.0 - rate)
                * nrm
            )
            eta_later = rate / (1.0 - rate)
            is_first = niter == 1
            eta_new = jnp.where(is_first, eta_first, eta_later)
            diverged = (~is_first) & ((rate > 0.9) | (proj > tol))
            converged = (eta_new * nrm < tol) & ~diverged
            status = jnp.where(
                diverged, DIVERGED, jnp.where(converged, CONVERGED, CONTINUE)
            ).astype(jnp.int32)
            return status, eta_new

        status0, eta = check(jnp.asarray(1, jnp.int32), nrm, nrm, eta)
        # if already converged on the first norm, take the full step
        x = jnp.where(status0 == CONVERGED, x - delta, x)

        def cond(carry):
            (_x, _delta, _nrm, _first, _eta, niter, status) = carry
            return (status == CONTINUE) & (niter < max_newton)

        def body(carry):
            (x, delta, nrm, first, eta, niter, _status) = carry
            phi0 = 0.5 * nrm * nrm
            two_phi0 = nrm * nrm
            min_alpha = steptol / nrm

            def ls_cond(ls):
                (_xt, _dt, _nt, alpha, i, done, failed) = ls
                return (~done) & (~failed) & (i < max_ls)

            def ls_body(ls):
                (_xt, _dt, _nt, alpha, i, _done, _failed) = ls
                x_try = x - alpha * delta
                d_try = lin(residual(x_try))
                n_try = wrms_norm(d_try, y_fixed, p.atol, p.rtol, nb)
                ok = 0.5 * n_try * n_try <= phi0 - armijo_c * alpha * two_phi0
                failed = (~ok) & (alpha < min_alpha)
                return (x_try, d_try, n_try, alpha * tau, i + 1, ok, failed)

            init = (x, delta, nrm, jnp.asarray(1.0, dtype),
                    jnp.asarray(0, jnp.int32), jnp.asarray(False), jnp.asarray(False))
            x_new, d_new, n_new, _a, i_ls, ok, ls_failed = jax.lax.while_loop(
                ls_cond, ls_body, init
            )
            niter = niter + 1
            status, eta = check(niter, n_new, first, eta)
            # line-search failure (or running out of alphas) -> diverged
            status = jnp.where(
                ok, status, jnp.asarray(DIVERGED, jnp.int32)
            )
            x = jnp.where(ok, x_new, x)
            delta = jnp.where(ok, d_new, delta)
            nrm = jnp.where(ok, n_new, nrm)
            return (x, delta, nrm, first, eta, niter, status)

        init = (x, delta, nrm, nrm, eta, jnp.asarray(1, jnp.int32), status0)
        x, _d, _n, _f, eta, _ni, status = jax.lax.while_loop(cond, body, init)
        return x, status, eta

    # outer loop: refactorize and retry up to max_setups times
    def outer_cond(carry):
        (_x, _eta, i, status) = carry
        return (status != CONVERGED) & (i < max_setups)

    def outer_body(carry):
        (x, eta, i, _status) = carry
        x, status, eta = newton_with_linesearch(x, eta)
        return (x, eta, i + 1, status)

    x, _eta, _i, status = jax.lax.while_loop(
        outer_cond,
        outer_body,
        (x0, jnp.asarray(ETA_RESET_JACOBIAN, dtype), jnp.asarray(0, jnp.int32),
         jnp.asarray(CONTINUE, jnp.int32)),
    )

    y_new = jnp.where(is_alg, x, y)
    dy_new = jnp.where(is_alg, 0.0, x)
    ok = status == CONVERGED
    out_status = jnp.where(
        ok, errors.INTERNAL_TIMESTEP, errors.INITIAL_CONDITION_DID_NOT_CONVERGE
    ).astype(jnp.int32)
    y_new = jnp.where(ok, y_new, y)
    dy_new = jnp.where(ok, dy_new, dy)
    return y_new, dy_new, out_status
