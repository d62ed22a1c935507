"""Augmented equation sets integrated alongside the main equations.

JAX equivalent of the reference's ``AugmentedOdeEquations`` interface
(reference crates/diffsol/src/ode_equations/mod.rs:42-186): ONE abstraction
behind forward sensitivities, adjoint systems and any future augmented
system, so the steppers implement augmented integration once.  Where the
reference iterates ``set_index(j)`` over augmented systems one at a time,
this design carries ALL rows at once as an ``(naug, ...)`` array and
vmaps — augmented rows ride a leading axis and every solve shares the main
equation's factorized iteration matrix.

Implementations:

* :class:`SensEquations` — continuous forward sensitivities
  (sens_equations.rs:10-208): rows s_i solve  M s_i' = J s_i + df/dp_i,
  with init rows dy0/dp_i, consistent-IC completion for DAEs and the
  event/reset jump corrections (state.rs:308-560 apply_reset_with_sens).
* the adjoint backward system reuses this interface through
  :func:`diffsol_tpu.adjoint` (the λ rows are the augmented rows of the
  time-reversed problem).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


class AugmentedEquations:
    """Interface for equation sets integrated alongside the main system.

    Rows are carried as one ``(naug,) + y.shape`` array ``S``.  Implicit
    steppers use :meth:`linear_parts` (the augmented rhs must be affine in
    S) so every augmented solve reuses the factorized ``M - c*J``; explicit
    steppers call :meth:`rhs` directly.
    """

    naug: int = 0
    include_in_error_control: bool = True

    def atol(self, problem):
        return problem.sens_atol if problem.sens_atol is not None else problem.atol

    def rtol(self, problem):
        return problem.sens_rtol if problem.sens_rtol is not None else problem.rtol

    def init(self, t0, y0, dy0, params):
        """Return (S0, dS0), each (naug,) + y.shape."""
        raise NotImplementedError

    def linear_parts(self, t, y, params):
        """Return (jvp_rows, forcing): rhs(S) == jvp_rows(S) + forcing."""
        raise NotImplementedError

    def rhs(self, t, y, params, S):
        jvp_rows, forcing = self.linear_parts(t, y, params)
        return jvp_rows(S) + forcing

    def mass_rows(self, problem, t, params, S):
        """Mass action applied to every augmented row."""
        return jax.vmap(lambda v: problem.eqn.mass_mul(t, params, v))(S)

    def apply_reset(self, t, y_minus, dy_minus, y_plus, dy_plus, params,
                    S, root_idx):
        """Correct the rows across a reset event (identity by default)."""
        return S


class SensEquations(AugmentedEquations):
    """Forward sensitivities s_i = dy/dp_i as augmented rows
    (reference SensEquations, sens_equations.rs:10-208).

    Works for flat states (n,) and lockstep states (n, B) with batched
    params (B, np) — the parameter-gradient rows f_p are built with np
    JVP probes (never a dense (B, np) jacobian, which would be quadratic
    in the ensemble size).
    """

    def __init__(self, problem):
        self.problem = problem
        self.naug = int(problem.eqn.nparams)

    # -- parameter-tangent seeds: rows of d(params)/dp_j ------------------
    def _param_seeds(self, params):
        eye = jnp.eye(self.naug, dtype=params.dtype)
        if jnp.ndim(params) == 2:  # lockstep (B, np): seed col j per member
            return jax.vmap(
                lambda e: jnp.broadcast_to(e[None, :], params.shape)
            )(eye)
        return eye

    def _f_p(self, t, y, params):
        """Rows (np,) + y.shape of df/dp via np JVP probes."""
        p = self.problem

        def probe(dp):
            return jax.jvp(lambda pp: p.eqn.rhs(t, y, pp), (params,), (dp,))[1]

        return jax.vmap(probe)(self._param_seeds(params))

    def linear_parts(self, t, y, params):
        p = self.problem
        _, jvp_fn = jax.linearize(lambda yy: p.eqn.rhs(t, yy, params), y)
        return jax.vmap(jvp_fn), self._f_p(t, y, params)

    def init(self, t0, y0, dy0, params):
        p = self.problem

        def init_probe(dp):
            return jax.jvp(lambda pp: p.eqn.init(t0, pp), (params,), (dp,))[1]

        S0 = jax.vmap(init_probe)(self._param_seeds(params))
        dS0 = self.rhs(t0, y0, params, S0)
        return S0, dS0

    def consistent_init(self, t0, y0, dy0, params, S0, is_alg):
        """Sens-consistent DAE initialization (reference
        state.rs:167-239 set_consistent_augmented / :1032
        new_with_sensitivities_and_consistent): with y partitioned into
        differential/algebraic by ``is_alg``, the algebraic sensitivity rows
        must satisfy the linearized constraint

            0 = d/dp g(y, p) = g_y_d s_d + g_y_a s_a + g_p

        so  s_a = -g_y_a^{-1} (g_y_d s_d + g_p)  row by row, where g is the
        algebraic part of f.  Solved with the same JVP machinery (one
        linearization, naug right-hand sides).
        """
        p = self.problem
        _, jvp_y = jax.linearize(lambda yy: p.eqn.rhs(t0, yy, params), y0)
        f_p = self._f_p(t0, y0, params)

        # Packed linear system: unknown x holds s_a on algebraic slots
        # (identity on differential slots so the operator is square):
        #   A(x) = where(alg, [f_y x_alg]_alg_rows, x)
        #   b_i  = where(alg, -([f_y s_d,i]_alg_rows + f_p,i), 0)
        # then s_a = x*_alg, assuming (f_y)_aa invertible (index-1 DAE,
        # the same assumption as the consistent-IC solve itself).
        def packed_apply(v):
            v_alg = jnp.where(is_alg, v, 0.0)
            return jnp.where(is_alg, jvp_y(v_alg), v)

        b_rows = jax.vmap(
            lambda s_i, fp_i: jnp.where(
                is_alg, -(jvp_y(jnp.where(is_alg, 0.0, s_i)) + fp_i), 0.0
            )
        )(S0, f_p)

        # materialize + factor the packed matrix with the tier matching the
        # problem (lockstep batch-last blocks / dense)
        from .ops import linsol

        if y0.ndim == 2:  # lockstep (n, B) state
            from .ops import smalllu

            n_mem = y0.shape[0]
            basis = jnp.eye(n_mem, dtype=y0.dtype)

            def col(e):
                v = jnp.broadcast_to(e[:, None], y0.shape)
                return packed_apply(v)

            cols = jax.vmap(col)(basis)
            jac = jnp.moveaxis(cols, 0, 1)  # (row, col, B)
            factors = smalllu.lu_factor_batch_last(jac)
            solve = lambda v: smalllu.lu_solve_batch_last(factors, v)
        else:
            from .solvers.consistent_ic import _blockwise_jacfwd

            jac = _blockwise_jacfwd(packed_apply, y0)
            factors = linsol.DENSE.factor(jac)
            solve = lambda v: linsol.DENSE.solve(factors, v)

        x = jax.vmap(solve)(b_rows)
        S = jnp.where(is_alg, x, S0)
        dS = self.rhs(t0, y0, params, S)
        return S, dS

    def apply_reset(self, t, y_minus, dy_minus, y_plus, dy_plus, params,
                    S, root_idx):
        """Sensitivity jump across a reset at a root event
        (reference state.rs:308-560 apply_reset_with_sens):

            dt*/dp_i = -(r_y s_i + r_p_i) / (r_y f- + r_t)     [active root]
            s_i+     = R_y s_i + R_p_i + (R_y f- + R_t - f+) dt*/dp_i

        evaluated at (y-, t*).  All rows at once; the active root index is
        traced.
        """
        p = self.problem
        eqn = p.eqn
        if eqn.reset_n is not None:
            reset = lambda tt, yy, pp: eqn.reset_n(tt, yy, pp, root_idx)
        else:
            reset = eqn.reset
        root = eqn.root

        # time partials via jvp in t (reference NonLinearOpTimePartial)
        def time_partial(f):
            return jax.jvp(lambda tt: f(tt), (t,), (jnp.ones_like(t),))[1]

        R_t = time_partial(lambda tt: reset(tt, y_minus, params))
        r_t = time_partial(lambda tt: root(tt, y_minus, params))

        _, R_y = jax.linearize(lambda yy: reset(t, yy, params), y_minus)
        _, r_y = jax.linearize(lambda yy: root(t, yy, params), y_minus)

        seeds = self._param_seeds(params)
        R_p = jax.vmap(
            lambda dp: jax.jvp(
                lambda pp: reset(t, y_minus, pp), (params,), (dp,)
            )[1]
        )(seeds)
        r_p = jax.vmap(
            lambda dp: jax.jvp(
                lambda pp: root(t, y_minus, pp), (params,), (dp,)
            )[1]
        )(seeds)

        flow = r_y(dy_minus) + r_t  # (nroots,)
        denom = flow[root_idx]
        c_dir = R_y(dy_minus) + R_t - dy_plus  # (n,)

        def row(s_i, r_p_i, R_p_i):
            dt_dp = -(r_y(s_i)[root_idx] + r_p_i[root_idx]) / denom
            return R_y(s_i) + R_p_i + c_dir * dt_dp

        return jax.vmap(row)(S, r_p, R_p)
