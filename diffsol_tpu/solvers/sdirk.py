"""SDIRK/ESDIRK stepper (TR-BDF2, ESDIRK34, custom tableaus).

JAX equivalent of the reference SDIRK solver
(reference crates/diffsol/src/ode_solver/sdirk.rs:90-560 on the shared RK
core runge_kutta.rs, stage operator op/sdirk.rs): each implicit stage solves

    F(z) = M z - h f(t + c_i h, phi_i + gamma z) = 0,
    phi_i = y_n + sum_{j<i} a_ij z_j,

by Newton against the frozen LU of ``M - gamma h J`` shared by all stages;
the embedded error estimate ``diff^T d`` is premultiplied by
``(M - gamma h J)^{-1}`` (after ``M`` when a mass matrix is present,
sdirk.rs:474-495), which upgrades the error estimator for stiff problems.
Stage Newton starts from polynomial extrapolation of previous stage values
(runge_kutta.rs:610-630).  The Jacobian-update policy and the
convergence-failure ladder are shared with BDF.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import errors
from ..norms import squared_norm, squared_norm_and_worst
from ..ops.controller import clamp_factor, pi_controller_raw
from ..ops.newton import ETA_RESET_JACOBIAN, ETA_RESET_TIMESTEP, newton_solve
from ..ops.rootfind import check_root
from ..problem import OdeProblem, SolverConfig
from .consistent_ic import algebraic_mask, make_consistent
from .rk_common import (
    RkState, Stats, interp_dy, interp_out, interp_sens, interp_y, tstop_check,
)
from .state import _flag_past_tstop, initial_state, initial_step_size
from .tableau import Tableau, tr_bdf2
from ..precision import highest_precision

# policy kinds (jacobian_update.rs)
_STEP_SUCCESS = 0
_FIRST_CONV_FAIL = 1
_SECOND_CONV_FAIL = 2
_ERROR_TEST_FAIL = 3
_CHECKPOINT = 4


class SdirkSolver:
    """Singly diagonally implicit RK method on an :class:`OdeProblem`."""

    def __init__(
        self,
        problem: OdeProblem,
        tableau: Optional[Tableau] = None,
        config: Optional[SolverConfig] = None,
        sens: bool = False,
        augmented=None,
    ):
        tab = tableau if tableau is not None else tr_bdf2()
        a = np.asarray(tab.a)
        gamma = a[-1, -1]
        if gamma == 0.0:
            raise ValueError("SDIRK tableau requires a nonzero diagonal coefficient")
        diag = np.diag(a)
        implicit_rows = np.arange(tab.s)[diag != 0.0]
        if not np.allclose(diag[implicit_rows], gamma):
            raise ValueError("SDIRK requires equal diagonal coefficients gamma")
        if not np.allclose(a[-1], np.asarray(tab.b)):
            raise ValueError("tableau must be stiffly accurate (a[-1] == b)")
        self.problem = problem
        self.tableau = tab
        self.gamma = float(gamma)
        self.config = config or SolverConfig.from_options(problem.options, "sdirk")
        self._alg_mask = algebraic_mask(problem)
        self._nb = problem.lockstep_nbatch
        # augmented rows solved per stage with the shared (M - h*gamma*J)
        # factorization (reference do_stage_sdirk, runge_kutta.rs:633-750)
        if augmented is None and sens:
            from ..augmented import SensEquations

            augmented = SensEquations(problem)
        self.aug = augmented
        self.sens = augmented is not None
        self.has_sens = self.sens
        # JVP probes per Jacobian evaluation (OpStatistics jac_mul_evals)
        self._jvp_probes = getattr(
            problem.eqn.rhs_jac, "jvp_probes", problem.eqn.nstates
        )

    def with_config(self, config: SolverConfig):
        """Mid-run configuration change (reference method.rs:84
        `config_mut`): returns a NEW solver over the same problem/tableau;
        continue from the previous solve's restartable ``state``."""
        return type(self)(
            self.problem, tableau=self.tableau, config=config,
            augmented=self.aug,
        )

    @property
    def order(self) -> int:
        return self.tableau.order

    # ------------------------------------------------------------------
    def _assemble_and_factor(self, t, y, params, h, stats):
        p = self.problem
        jac = p.eqn.jac(t, y, params)
        mass = p.eqn.mass_repr(t, params)
        a = p.linear_solver.assemble(mass, jac, self.gamma * h)
        factors = p.linear_solver.factor(a)
        stats = stats._replace(
            jacobian_evals=stats.jacobian_evals + 1,
            linear_solver_setups=stats.linear_solver_setups + 1,
            jac_mul_evals=stats.jac_mul_evals + self._jvp_probes,
            mass_evals=stats.mass_evals + int(p.eqn.mass is not None),
        )
        return jac, factors, stats

    def _refactor(self, t, params, jac, h, stats):
        p = self.problem
        mass = p.eqn.mass_repr(t, params)
        a = p.linear_solver.assemble(mass, jac, self.gamma * h)
        factors = p.linear_solver.factor(a)
        stats = stats._replace(linear_solver_setups=stats.linear_solver_setups + 1)
        return factors, stats

    def _jacobian_updates(self, st: dict, t, y, params, h, kind):
        """Shared Jacobian-update policy (sdirk.rs:256-304); the step-size
        proxy for SDIRK is h itself."""
        opts = self.problem.options
        ssj = st["steps_since_jac"]
        ssrj = st["steps_since_rhs_jac"]
        h_last = st["h_at_last_jac"]
        rel = jnp.abs(h / h_last - 1.0)

        rhs_pred = jnp.select(
            [
                kind == _STEP_SUCCESS,
                kind == _FIRST_CONV_FAIL,
                kind == _SECOND_CONV_FAIL,
                kind == _ERROR_TEST_FAIL,
            ],
            [
                ssrj >= opts.update_rhs_jacobian_after_steps,
                rel < opts.threshold_to_update_rhs_jacobian,
                ssrj > 0,
                jnp.asarray(False),
            ],
            default=jnp.asarray(True),
        )
        jac_pred = jnp.select(
            [kind == _STEP_SUCCESS],
            [
                (ssj >= opts.update_jacobian_after_steps)
                | (rel > opts.threshold_to_update_jacobian)
            ],
            default=jnp.asarray(True),
        )

        def do_rhs(_):
            jac, factors, stats = self._assemble_and_factor(t, y, params, h, st["stats"])
            return (
                jac, factors, stats,
                jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), h,
                jnp.asarray(ETA_RESET_JACOBIAN, h.dtype),
            )

        def do_factor(_):
            factors, stats = self._refactor(t, params, st["jac"], h, st["stats"])
            return (
                st["jac"], factors, stats,
                jnp.asarray(0, jnp.int32), ssrj, h,
                jnp.asarray(ETA_RESET_JACOBIAN, h.dtype),
            )

        def do_nothing(_):
            return (st["jac"], st["factors"], st["stats"], ssj, ssrj, h_last, st["eta"])

        branch = jnp.where(rhs_pred, 0, jnp.where(jac_pred, 1, 2))
        jac, factors, stats, ssj, ssrj, h_last, eta = jax.lax.switch(
            branch, [do_rhs, do_factor, do_nothing], None
        )
        # per-cause LU-setup breakdown (ode_solver/mod.rs:53-70)
        inc = (branch != 2).astype(jnp.int32)
        stats = stats._replace(
            lu_from_checkpoint=stats.lu_from_checkpoint
            + inc * (kind == _CHECKPOINT),
            lu_from_first_fail=stats.lu_from_first_fail
            + inc * (kind == _FIRST_CONV_FAIL),
            lu_from_second_fail=stats.lu_from_second_fail
            + inc * (kind == _SECOND_CONV_FAIL),
            lu_from_error_test=stats.lu_from_error_test
            + inc * (kind == _ERROR_TEST_FAIL),
            lu_from_step_success=stats.lu_from_step_success
            + inc * (kind == _STEP_SUCCESS),
        )
        st = dict(st)
        st.update(
            jac=jac, factors=factors, stats=stats,
            steps_since_jac=ssj, steps_since_rhs_jac=ssrj,
            h_at_last_jac=h_last, eta=eta,
        )
        return st

    # ------------------------------------------------------------------
    @highest_precision
    def init_state(self, params=None) -> RkState:
        p = self.problem
        params = p.params if params is None else params
        y, dy, g, dg = initial_state(p, params)
        ic_status = jnp.asarray(errors.INTERNAL_TIMESTEP, jnp.int32)
        if self._alg_mask is not None:
            y, dy, ic_status = make_consistent(p, params, y, dy, self._alg_mask)
        h = initial_step_size(p, params, y, dy, self.order)
        dtype = y.dtype
        s = self.tableau.s
        stats = Stats.zeros()
        jac, factors, stats = self._assemble_and_factor(
            jnp.asarray(p.t0, dtype), y, params, h, stats
        )
        stats = stats._replace(
            lu_from_checkpoint=stats.lu_from_checkpoint + 1
        )
        root_g = (
            p.eqn.root(p.t0, y, params)
            if p.eqn.root is not None
            else jnp.zeros((0,), dtype)
        )
        nan = jnp.asarray(jnp.nan, dtype)
        s_f = ds_f = sdiff_f = None
        if self.sens:
            t0 = jnp.asarray(p.t0, dtype)
            s_f, ds_f = self.aug.init(t0, y, dy, params)
            if self._alg_mask is not None and hasattr(self.aug, "consistent_init"):
                s_f, ds_f = self.aug.consistent_init(
                    t0, y, dy, params, s_f, self._alg_mask
                )
            sdiff_f = jnp.zeros((s_f.shape[0], s) + y.shape, dtype)
        return RkState(
            y=y, dy=dy, g=g, t=jnp.asarray(p.t0, dtype), h=h,
            y_prev=y, dy_prev=dy, g_prev=g, t_prev=jnp.asarray(p.t0, dtype),
            diff=jnp.zeros((s,) + y.shape, dtype),
            gdiff=jnp.zeros((s,) + g.shape, dtype),
            prev_error_norm=nan,
            root_g=root_g, tstop=nan,
            status=ic_status,
            root_t=nan, root_idx=jnp.asarray(-1, jnp.int32),
            state_modified=jnp.asarray(False),
            stats=stats,
            jac=jac, factors=factors,
            eta=jnp.asarray(ETA_RESET_JACOBIAN, dtype),
            steps_since_jac=jnp.asarray(0, jnp.int32),
            steps_since_rhs_jac=jnp.asarray(0, jnp.int32),
            h_at_last_jac=h,
            s=s_f, ds=ds_f, sdiff=sdiff_f, s_prev=s_f,
        )

    def set_stop_time(self, state: RkState, tstop) -> RkState:
        tstop = jnp.asarray(tstop, state.t.dtype)
        _, h_adj = tstop_check(state.t, state.h, tstop, state.t.dtype)
        state = state.replace(tstop=tstop, h=h_adj)
        return _flag_past_tstop(state, tstop)

    def reinit_after_reset(self, state: RkState, params) -> RkState:
        p = self.problem
        dy = p.eqn.rhs(state.t, state.y, params)
        if self._alg_mask is None:
            return state.replace(dy=dy)
        y, dy, status = make_consistent(
            p, params, state.y, dy, self._alg_mask, t=state.t
        )
        return state.replace(y=y, dy=dy, status=status)

    # ------------------------------------------------------------------
    def _stage_predict(self, i: int, h, dy0, diff):
        """Newton starting guess for stage i (runge_kutta.rs:610-630)."""
        tab = self.tableau
        if i == 0:
            return h * dy0
        if i == 1:
            return diff[0]
        c = np.asarray(tab.c)
        cc = (c[i] - c[i - 2]) / (c[i - 1] - c[i - 2])
        return (1.0 + cc) * diff[i - 1] - cc * diff[i - 2]

    def _stage_predict_rows(self, i: int, h, ds0, sdiff):
        """Stage prediction for the augmented rows (sdiff is (naug, s, ...))."""
        tab = self.tableau
        if i == 0:
            return h * ds0
        if i == 1:
            return sdiff[:, 0]
        c = np.asarray(tab.c)
        cc = (c[i] - c[i - 2]) / (c[i - 1] - c[i - 2])
        return (1.0 + cc) * sdiff[:, i - 1] - cc * sdiff[:, i - 2]

    @highest_precision
    def step(self, state: RkState, params=None) -> RkState:
        """One adaptive SDIRK step (sdirk.rs:409-545)."""
        p = self.problem
        cfg = self.config
        opts = p.options
        tab = self.tableau
        params = p.params if params is None else params
        dtype = state.y.dtype
        s = tab.s
        a_np = np.asarray(tab.a)
        c_np = np.asarray(tab.c)
        d_vec = jnp.asarray(np.asarray(tab.d), dtype)
        b_vec = jnp.asarray(np.asarray(tab.b), dtype)
        gamma = self.gamma
        start = 1 if tab.skip_first_stage else 0
        has_mass = p.eqn.mass is not None
        integrate_out = p.integrate_out

        if p.eqn.root is not None:
            root_g = jnp.where(
                state.state_modified,
                p.eqn.root(state.t, state.y, params),
                state.root_g,
            )
        else:
            root_g = state.root_g
        if integrate_out:
            g_dg = (
                p.eqn.out(state.t, state.y, params)
                if p.eqn.out is not None
                else state.y
            )
        else:
            g_dg = jnp.zeros((0,), dtype)

        st0 = dict(
            jac=state.jac, factors=state.factors, eta=state.eta, stats=state.stats,
            steps_since_jac=state.steps_since_jac,
            steps_since_rhs_jac=state.steps_since_rhs_jac,
            h_at_last_jac=state.h_at_last_jac,
        )

        if self.sens:
            # refresh row derivatives at reset-corrected rows (see drivers
            # _apply_reset + aug.apply_reset)
            ds0 = jnp.where(
                state.state_modified,
                self.aug.rhs(state.t, state.y, params, state.s),
                state.ds,
            )
        else:
            ds0 = None

        def solve_stage(i, h, diff, sdiff, st, failed):
            """Solve stage i (+ augmented rows); returns
            (diff, y_stage, z, sdiff, s_stage, sz, st, failed, niter)."""
            t_i = state.t + c_np[i] * h
            arow = jnp.asarray(a_np[i, :i], dtype) if i > 0 else None
            if i > 0:
                phi = state.y + jnp.tensordot(arow, diff[:i], axes=1)
            else:
                phi = state.y
            z0 = self._stage_predict(i, h, state.dy, diff)

            def residual(z):
                yz = phi + gamma * z
                fz = p.eqn.rhs(t_i, yz, params)
                return p.eqn.mass_mul(t_i, params, z) - h * fz

            lin_solve = lambda v: p.linear_solver.solve(st["factors"], v)
            res = newton_solve(
                residual, lin_solve, z0, state.y, p.atol, p.rtol, st["eta"],
                tol=opts.nonlinear_solver_tolerance,
                max_iter=cfg.maximum_newton_iterations,
                nbatch=self._nb,
            )
            st = dict(st, eta=res.eta)
            niter = res.niter
            z = res.x
            y_stage = phi + gamma * z
            diff = diff.at[i].set(z)
            failed = failed | ~res.converged

            # augmented stage rows: M sz = h (J (sphi + gamma sz) + f_p),
            # Newton against the SAME factorization (runge_kutta.rs:695-740)
            if self.sens:
                jvp_rows, f_p = self.aug.linear_parts(t_i, y_stage, params)
                if i > 0:
                    sphi = state.s + jnp.tensordot(
                        arow, sdiff[:, :i], axes=[[0], [1]]
                    )
                else:
                    sphi = state.s
                sz0 = self._stage_predict_rows(i, h, ds0, sdiff)

                def residual_s(SZ):
                    s_state = sphi + gamma * SZ
                    rhs_s = jvp_rows(s_state) + f_p
                    return (
                        self.aug.mass_rows(p, t_i, params, SZ) - h * rhs_s
                    )

                res_s = newton_solve(
                    residual_s, lin_solve, sz0, state.s,
                    self.aug.atol(p), self.aug.rtol(p), st["eta"],
                    tol=opts.nonlinear_solver_tolerance,
                    max_iter=cfg.maximum_newton_iterations,
                    nbatch=self._nb,
                )
                sz = res_s.x
                sdiff = sdiff.at[:, i].set(sz)
                s_stage = sphi + gamma * sz
                failed = failed | ~res_s.converged
                niter = niter + res_s.niter
            else:
                s_stage = state.s
                sz = None

            st["stats"] = st["stats"]._replace(
                newton_iterations=st["stats"].newton_iterations + niter,
                # one rhs evaluation per stage-Newton iteration
                rhs_evals=st["stats"].rhs_evals + niter,
            )
            return diff, y_stage, z, sdiff, s_stage, sz, st, failed, niter

        def attempt_cond(c):
            return (~c["accepted"]) & (c["status"] == errors.INTERNAL_TIMESTEP)

        def attempt_body(c):
            h = c["h"]
            st = c["st"]
            diff = jnp.zeros_like(state.diff)
            gdiff = jnp.zeros_like(state.gdiff)
            sdiff = None if state.sdiff is None else jnp.zeros_like(state.sdiff)
            if start == 1:
                diff = diff.at[0].set(h * state.dy)
                if integrate_out:
                    gdiff = gdiff.at[0].set(h * g_dg)
                if self.sens:
                    sdiff = sdiff.at[:, 0].set(h * ds0)

            failed = jnp.asarray(False)
            y_stage = state.y
            z_last = diff[0]
            s_stage = state.s
            sz_last = None if state.s is None else (
                sdiff[:, 0] if start == 1 else jnp.zeros_like(state.s)
            )
            niter = jnp.asarray(0, jnp.int32)
            for i in range(start, s):
                # skip stage work if a previous stage already failed
                def do(args):
                    diff, _ys, _z, sdiff, _ss, _sz, st, failed, _ni = args
                    return solve_stage(i, h, diff, sdiff, st, failed)

                def skip(args):
                    return args

                (
                    diff, y_stage, z_last, sdiff, s_stage, sz_last, st,
                    failed, niter,
                ) = jax.lax.cond(
                    failed, skip, do,
                    (
                        diff, y_stage, z_last, sdiff, s_stage, sz_last, st,
                        failed, niter,
                    ),
                )
                if integrate_out:
                    t_i = state.t + c_np[i] * h
                    dg_i = (
                        p.eqn.out(t_i, y_stage, params)
                        if p.eqn.out is not None
                        else y_stage
                    )
                    gdiff = gdiff.at[i].set(h * dg_i)

            # ---------------- failure handling ----------------
            def on_fail(args):
                c, st = args
                newton_fails = c["newton_fails"] + 1
                st = dict(st)
                st["stats"] = st["stats"]._replace(
                    newton_fails=st["stats"].newton_fails + 1
                )
                too_many = newton_fails > cfg.maximum_newton_fails

                def second(args):
                    c, st = args
                    h2 = c["h"] * 0.3
                    st = dict(st, eta=jnp.asarray(ETA_RESET_TIMESTEP, dtype))
                    st = self._jacobian_updates(
                        st, state.t, state.y, params, h2,
                        jnp.asarray(_SECOND_CONV_FAIL, jnp.int32),
                    )
                    return dict(c, st=st, h=h2)

                def first(args):
                    c, st = args
                    st = self._jacobian_updates(
                        st, state.t, state.y, params, c["h"],
                        jnp.asarray(_FIRST_CONV_FAIL, jnp.int32),
                    )
                    return dict(c, st=st, updated_jac=jnp.asarray(True))

                out = jax.lax.cond(c["updated_jac"], second, first, (c, st))
                too_small = jnp.abs(out["h"]) < cfg.minimum_timestep
                status = jnp.where(
                    too_many, errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES, out["status"]
                )
                status = jnp.where(
                    too_small, errors.STEP_SIZE_TOO_SMALL, status
                ).astype(jnp.int32)
                return dict(
                    out,
                    newton_fails=newton_fails,
                    prev_err=jnp.asarray(jnp.nan, dtype),
                    status=status,
                )

            # ---------------- error test ----------------
            def on_ok(args):
                c, st = args
                err_vec = jnp.tensordot(d_vec, diff, axes=1)
                if has_mass:
                    err_vec = p.eqn.mass_mul(state.t, params, err_vec)
                err_vec = p.linear_solver.solve(st["factors"], err_vec)
                err, wm = squared_norm_and_worst(
                    err_vec, state.y, p.atol, p.rtol, self._nb
                )
                if p.output_in_error_control():
                    gerr = jnp.tensordot(d_vec, gdiff, axes=1)
                    err = jnp.maximum(
                        err,
                        squared_norm(
                            gerr, state.g, p.out_atol, p.out_rtol, self._nb
                        ),
                    )
                if self.sens and p.sens_in_error_control():
                    serr_rows = jnp.tensordot(sdiff, d_vec, axes=[[1], [0]])
                    if has_mass:
                        serr_rows = self.aug.mass_rows(
                            p, state.t, params, serr_rows
                        )
                    serr_rows = jax.vmap(
                        lambda v: p.linear_solver.solve(st["factors"], v)
                    )(serr_rows)
                    s_errs = jax.vmap(
                        lambda sd, sv: squared_norm(
                            sd, sv, self.aug.atol(p), self.aug.rtol(p), self._nb
                        )
                    )(serr_rows, state.s)
                    err = jnp.maximum(err, jnp.max(s_errs))
                m = float(cfg.maximum_newton_iterations)
                safety = (2.0 * m + 1.0) / (2.0 * m + niter.astype(dtype))
                raw = pi_controller_raw(
                    err, c["prev_err"],
                    opts.pi_control_integral, opts.pi_control_proportional,
                    self.order + 1,
                )
                factor = clamp_factor(
                    0.9 * safety * raw,
                    cfg.minimum_timestep_shrink, cfg.maximum_timestep_shrink,
                    cfg.minimum_timestep_growth, cfg.maximum_timestep_growth,
                )
                accepted = err < 1.0

                def reject(args):
                    c, st = args
                    h2 = c["h"] * factor
                    st = dict(st, eta=jnp.asarray(ETA_RESET_TIMESTEP, dtype))
                    st["stats"] = st["stats"]._replace(
                        error_test_failures=st["stats"].error_test_failures + 1
                    )
                    st = self._jacobian_updates(
                        st, state.t, state.y, params, h2,
                        jnp.asarray(_ERROR_TEST_FAIL, jnp.int32),
                    )
                    natt = c["nattempts"] + 1
                    status = c["status"]
                    status = jnp.where(
                        natt >= cfg.maximum_error_test_failures,
                        errors.TOO_MANY_ERROR_TEST_FAILURES, status,
                    )
                    status = jnp.where(
                        jnp.abs(h2) < cfg.minimum_timestep,
                        errors.STEP_SIZE_TOO_SMALL, status,
                    ).astype(jnp.int32)
                    return dict(
                        c, st=st, h=h2, nattempts=natt,
                        prev_err=jnp.asarray(jnp.nan, dtype),
                        status=status, wm=wm,
                    )

                def accept(args):
                    c, st = args
                    return dict(
                        c, st=st,
                        diff=diff, gdiff=gdiff, sdiff=sdiff,
                        y_new=y_stage, z_last=z_last,
                        s_new=s_stage, sz_last=sz_last,
                        err=err, factor=factor,
                        accepted=jnp.asarray(True), wm=wm,
                    )

                return jax.lax.cond(accepted, accept, reject, (c, st))

            return jax.lax.cond(failed, on_fail, on_ok, (dict(c, st=st), st))

        carry0 = dict(
            st=st0, h=state.h,
            diff=state.diff, gdiff=state.gdiff, sdiff=state.sdiff,
            y_new=state.y, z_last=state.diff[0] if s > 0 else state.dy,
            s_new=state.s,
            sz_last=None if state.sdiff is None else state.sdiff[:, 0],
            err=jnp.asarray(jnp.inf, dtype),
            factor=jnp.asarray(1.0, dtype),
            prev_err=state.prev_error_norm,
            updated_jac=jnp.asarray(False),
            newton_fails=jnp.asarray(
                state.stats.newton_fails, jnp.int32
            ),
            nattempts=jnp.asarray(0, jnp.int32),
            accepted=jnp.asarray(False),
            status=jnp.asarray(errors.INTERNAL_TIMESTEP, jnp.int32),
            wm=state.stats.worst_member,
        )
        carry = jax.lax.while_loop(attempt_cond, attempt_body, carry0)
        failed = carry["status"] != errors.INTERNAL_TIMESTEP

        st = carry["st"]
        h = carry["h"]
        new_h = h * carry["factor"]
        # jacobian updates for the next step at the new step size
        st = dict(
            st,
            eta=jnp.where(
                carry["factor"] != 1.0,
                jnp.asarray(ETA_RESET_TIMESTEP, dtype),
                st["eta"],
            ),
        )
        t_new = state.t + h
        y_new = carry["y_new"]
        st = self._jacobian_updates(
            st, t_new, y_new, params, new_h, jnp.asarray(_STEP_SUCCESS, jnp.int32)
        )
        st["steps_since_jac"] = st["steps_since_jac"] + 1
        st["steps_since_rhs_jac"] = st["steps_since_rhs_jac"] + 1
        st["stats"] = st["stats"]._replace(steps=st["stats"].steps + 1)

        dy_new = carry["z_last"] / h
        g_new = (
            state.g + jnp.tensordot(b_vec, carry["gdiff"], axes=1)
            if integrate_out
            else state.g
        )
        sens_upd = {}
        if self.sens:
            sens_upd = dict(
                s=carry["s_new"], ds=carry["sz_last"] / h,
                sdiff=carry["sdiff"], s_prev=state.s,
            )

        new_state = state.replace(
            y=y_new, dy=dy_new, g=g_new, t=t_new, h=new_h,
            y_prev=state.y, dy_prev=state.dy, g_prev=state.g, t_prev=state.t,
            diff=carry["diff"], gdiff=carry["gdiff"],
            prev_error_norm=carry["err"],
            root_g=root_g,
            state_modified=jnp.asarray(False),
            **sens_upd,
            jac=st["jac"], factors=st["factors"], eta=st["eta"],
            steps_since_jac=st["steps_since_jac"],
            steps_since_rhs_jac=st["steps_since_rhs_jac"],
            h_at_last_jac=st["h_at_last_jac"],
            stats=st["stats"]._replace(
                newton_fails=carry["newton_fails"],
                error_test_failures=st["stats"].error_test_failures,
                worst_member=carry["wm"],
            ),
        )

        stop = jnp.asarray(errors.INTERNAL_TIMESTEP, jnp.int32)
        root_t = jnp.asarray(jnp.nan, dtype)
        root_idx = jnp.asarray(-1, jnp.int32)
        if p.eqn.root is not None:
            res = check_root(
                lambda tt, yy: p.eqn.root(tt, yy, params),
                lambda tt: interp_y(tab, new_state, tt),
                root_g, state.t, y_new, t_new,
                nbatch=self._nb,
            )
            stop = jnp.where(res.found, errors.ROOT_FOUND, stop).astype(jnp.int32)
            stop = jnp.where(
                res.inconsistent, errors.ROOT_BATCH_INCONSISTENT, stop
            ).astype(jnp.int32)
            root_t = jnp.where(res.found, res.t_root, root_t)
            root_idx = jnp.where(res.found, res.root_idx, root_idx)
            new_state = new_state.replace(root_g=res.g0_next)

        reached, h_adj = tstop_check(t_new, new_state.h, state.tstop, dtype)
        stop = jnp.where(
            (stop == errors.INTERNAL_TIMESTEP) & reached, errors.TSTOP_REACHED, stop
        ).astype(jnp.int32)
        new_state = new_state.replace(
            h=h_adj, status=stop, root_t=root_t, root_idx=root_idx
        )

        final_status = jnp.where(failed, carry["status"], new_state.status).astype(
            jnp.int32
        )
        out = jax.tree_util.tree_map(
            lambda new, old: jnp.where(failed, old, new), new_state, state
        )
        return out.replace(status=final_status)

    # ------------------------------------------------------------------
    def interpolate(self, state: RkState, t):
        return interp_y(self.tableau, state, t)

    def interpolate_dy(self, state: RkState, t):
        return interp_dy(self.tableau, state, t)

    def interpolate_out(self, state: RkState, t):
        return interp_out(self.tableau, state, t)

    def interpolate_sens(self, state: RkState, t):
        return interp_sens(self.tableau, state, t)
