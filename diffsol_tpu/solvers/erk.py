"""Adaptive explicit Runge-Kutta stepper (TSIT45 and custom tableaus).

JAX equivalent of the reference explicit RK solver
(reference crates/diffsol/src/ode_solver/explicit_rk.rs:75-250 `ExplicitRk`
on the shared core runge_kutta.rs): one adaptive step is a pure function
``state -> state`` whose step-rejection loop is a ``lax.while_loop`` with the
stages unrolled statically, so whole solves jit-compile to a single XLA
while program and ``vmap`` turns the stepper into an ensemble stepper.

Requirements checked at construction (runge_kutta.rs:232-284): no mass
matrix; the tableau must be explicit, stiffly accurate (last row of ``a``
equals ``b``) with c[0]=0 and c[-1]=1 so the final stage evaluates the
solution and gives FSAL reuse.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import errors
from ..norms import squared_norm, squared_norm_and_worst
from ..ops.controller import clamp_factor, pi_controller_raw
from ..ops.rootfind import check_root
from ..problem import OdeProblem, SolverConfig
from .rk_common import (
    RkState, Stats, interp_dy, interp_out, interp_sens, interp_y, lincomb,
    tstop_check,
)
from .state import _flag_past_tstop, initial_state, initial_step_size
from .tableau import Tableau, tsit45
from ..precision import highest_precision


class ErkSolver:
    """Explicit RK method on an :class:`OdeProblem` (no mass matrix)."""

    def __init__(
        self,
        problem: OdeProblem,
        tableau: Optional[Tableau] = None,
        config: Optional[SolverConfig] = None,
        sens: bool = False,
        augmented=None,
    ):
        if problem.eqn.mass is not None:
            raise ValueError("explicit RK does not support mass matrices")
        tab = tableau if tableau is not None else tsit45()
        a = np.asarray(tab.a)
        if not np.allclose(np.triu(a), 0.0):
            raise ValueError("explicit RK requires a strictly lower-triangular tableau")
        if not (tab.c[0] == 0.0 and tab.c[-1] == 1.0):
            raise ValueError("tableau must have c[0]=0 and c[-1]=1")
        if not np.allclose(a[-1], np.asarray(tab.b)):
            raise ValueError("tableau must be stiffly accurate (a[-1] == b)")
        self.problem = problem
        self.tableau = tab
        self.config = config or SolverConfig.from_options(problem.options, "erk")
        self._nb = problem.lockstep_nbatch
        # augmented rows integrated through the same stages (reference
        # AugmentedOdeEquations + do_stage, runge_kutta.rs:537-608)
        if augmented is None and sens:
            from ..augmented import SensEquations

            augmented = SensEquations(problem)
        self.aug = augmented
        self.sens = augmented is not None
        self.has_sens = self.sens

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
    @highest_precision
    def init_state(self, params=None) -> RkState:
        p = self.problem
        params = p.params if params is None else params
        y, dy, g, dg = initial_state(p, params)
        h = initial_step_size(p, params, y, dy, self.order)
        dtype = y.dtype
        s = self.tableau.s
        n = y.shape[-1]
        nroots = p.eqn.nroots
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
            sdiff_f = jnp.zeros((s_f.shape[0], s) + y.shape, dtype)
        return RkState(
            y=y, dy=dy, g=g, t=jnp.asarray(p.t0, dtype), h=h,
            y_prev=y, dy_prev=dy, g_prev=g, t_prev=jnp.asarray(p.t0, dtype),
            diff=jnp.zeros((s,) + y.shape, dtype),
            gdiff=jnp.zeros((s,) + g.shape, dtype),
            prev_error_norm=nan,
            root_g=root_g,
            tstop=nan,
            status=jnp.asarray(errors.INTERNAL_TIMESTEP, jnp.int32),
            root_t=nan,
            root_idx=jnp.asarray(-1, jnp.int32),
            state_modified=jnp.asarray(False),
            stats=Stats.zeros(),
            s=s_f, ds=ds_f, sdiff=sdiff_f, s_prev=s_f,
        )

    def reinit_after_reset(self, state: RkState, params) -> RkState:
        dy = self.problem.eqn.rhs(state.t, state.y, params)
        return state.replace(dy=dy)

    def set_stop_time(self, state: RkState, tstop) -> RkState:
        tstop = jnp.asarray(tstop, state.t.dtype)
        # adjust h immediately if the next step would overshoot
        # (reference runge_kutta.rs:436-444 set_stop_time -> handle_tstop)
        _, h_adj = tstop_check(state.t, state.h, tstop, state.t.dtype)
        state = state.replace(tstop=tstop, h=h_adj)
        return _flag_past_tstop(state, tstop)

    # ------------------------------------------------------------------
    def _stages(self, h, y, dy, g_dg, t, params, s_rows=None, ds_rows=None):
        """Unrolled explicit stages; returns
        (diff, gdiff, y_new, dy_new, dg_new, sdiff, s_new, ds_new).
        Augmented rows run through the same stages
        (reference do_stage, runge_kutta.rs:537-608)."""
        p = self.problem
        tab = self.tableau
        s = tab.s
        dtype = y.dtype
        a = np.asarray(tab.a)
        c = np.asarray(tab.c)
        diff_rows = [h * dy]
        gdiff_rows = []
        integrate_out = p.integrate_out
        if integrate_out:
            gdiff_rows.append(h * g_dg)
        sens = self.sens and s_rows is not None
        if sens:
            sdiff_rows = [h * ds_rows]
            s_i, dS_i = s_rows, ds_rows
        y_i = y
        k_i = dy
        for i in range(1, s):
            y_i = y + lincomb(a[i, :i], diff_rows)
            t_i = t + c[i] * h
            k_i = p.eqn.rhs(t_i, y_i, params)
            diff_rows.append(h * k_i)
            if sens:
                # stage rows: s + sum_j a_ij sdiff_j (stacked axis 0 = stage)
                s_i = s_rows + lincomb(a[i, :i], sdiff_rows)
                dS_i = self.aug.rhs(t_i, y_i, params, s_i)
                sdiff_rows.append(h * dS_i)
            if integrate_out:
                if p.eqn.out is not None:
                    dg_i = p.eqn.out(t_i, y_i, params)
                else:
                    dg_i = y_i
                gdiff_rows.append(h * dg_i)
        diff = jnp.stack(diff_rows)
        if integrate_out:
            gdiff = jnp.stack(gdiff_rows)
            dg_new = gdiff_rows[-1] / h
        else:
            gdiff = jnp.zeros((s,) + g_dg.shape, dtype)
            dg_new = g_dg
        if sens:
            sdiff = jnp.stack(sdiff_rows, axis=1)  # (naug, s, ...)
            return diff, gdiff, y_i, k_i, dg_new, sdiff, s_i, dS_i
        return diff, gdiff, y_i, k_i, dg_new, None, None, None

    @highest_precision
    def step(self, state: RkState, params=None) -> RkState:
        """One adaptive step (explicit_rk.rs:196-243)."""
        p = self.problem
        cfg = self.config
        tab = self.tableau
        params = p.params if params is None else params
        dtype = state.y.dtype
        d_np = np.asarray(tab.d)

        # state-modified handling: refresh root-function values (start_step)
        if p.eqn.root is not None:
            root_g = jnp.where(
                state.state_modified,
                p.eqn.root(state.t, state.y, params),
                state.root_g,
            )
        else:
            root_g = state.root_g

        # dg at current state (for gdiff[0]); recomputed cheaply
        if p.integrate_out:
            g_dg = (
                p.eqn.out(state.t, state.y, params)
                if p.eqn.out is not None
                else state.y
            )
        else:
            g_dg = jnp.zeros((0,), dtype)

        # after a reset the augmented-row derivatives must be refreshed at
        # the corrected rows (the driver corrected s via aug.apply_reset)
        if self.sens:
            ds0 = jnp.where(
                state.state_modified,
                self.aug.rhs(state.t, state.y, params, state.s),
                state.ds,
            )
        else:
            ds0 = None

        def attempt_cond(c):
            return (~c["accepted"]) & (c["status"] == errors.INTERNAL_TIMESTEP)

        def attempt_body(c):
            h = c["h"]
            (diff, gdiff, y_new, dy_new, dg_new, sdiff, s_new, ds_new) = (
                self._stages(
                    h, state.y, state.dy, g_dg, state.t, params,
                    s_rows=state.s if self.sens else None,
                    ds_rows=ds0,
                )
            )
            err_vec = lincomb(d_np, diff)
            err, wm = squared_norm_and_worst(
                err_vec, state.y, p.atol, p.rtol, self._nb
            )
            if p.output_in_error_control():
                gerr = lincomb(d_np, gdiff)
                err = jnp.maximum(
                    err,
                    squared_norm(gerr, state.g, p.out_atol, p.out_rtol, self._nb),
                )
            if self.sens and p.sens_in_error_control():
                serr_rows = lincomb(d_np, jnp.moveaxis(sdiff, 1, 0))
                s_errs = jax.vmap(
                    lambda sd, sv: squared_norm(
                        sd, sv, self.aug.atol(p), self.aug.rtol(p), self._nb
                    )
                )(serr_rows, state.s)
                err = jnp.maximum(err, jnp.max(s_errs))
            accepted = err < 1.0
            raw = pi_controller_raw(
                err, c["prev"],
                p.options.pi_control_integral, p.options.pi_control_proportional,
                self.order + 1,
            )
            factor = clamp_factor(
                0.9 * raw,
                cfg.minimum_timestep_shrink, cfg.maximum_timestep_shrink,
                cfg.minimum_timestep_growth, cfg.maximum_timestep_growth,
            )
            h_next = jnp.where(accepted, h, h * factor)
            natt = jnp.where(accepted, c["natt"], c["natt"] + 1)
            prev = jnp.where(accepted, c["prev"], jnp.asarray(jnp.nan, dtype))
            too_many = (~accepted) & (natt >= cfg.maximum_error_test_failures)
            too_small = (~accepted) & (jnp.abs(h_next) < cfg.minimum_timestep)
            status = jnp.where(
                too_many,
                errors.TOO_MANY_ERROR_TEST_FAILURES,
                jnp.where(too_small, errors.STEP_SIZE_TOO_SMALL, c["status"]),
            ).astype(jnp.int32)
            return dict(
                h=h_next, diff=diff, gdiff=gdiff, y_new=y_new, dy_new=dy_new,
                dg_new=dg_new, sdiff=sdiff, s_new=s_new, ds_new=ds_new,
                natt=natt, prev=prev, err=err, status=status,
                accepted=accepted, wm=wm,
            )

        init = dict(
            h=state.h, diff=state.diff, gdiff=state.gdiff,
            y_new=state.y, dy_new=state.dy, dg_new=g_dg,
            sdiff=state.sdiff, s_new=state.s, ds_new=ds0,
            natt=jnp.asarray(0, jnp.int32),
            prev=state.prev_error_norm,
            err=jnp.asarray(jnp.inf, dtype),
            status=jnp.asarray(errors.INTERNAL_TIMESTEP, jnp.int32),
            accepted=jnp.asarray(False),
            wm=state.stats.worst_member,
        )
        carry = jax.lax.while_loop(attempt_cond, attempt_body, init)
        (h, diff, gdiff, y_new, dy_new, dg_new, natt, err, status) = (
            carry["h"], carry["diff"], carry["gdiff"], carry["y_new"],
            carry["dy_new"], carry["dg_new"], carry["natt"], carry["err"],
            carry["status"],
        )

        # compute controller factor for the accepted step
        raw = pi_controller_raw(
            err, state.prev_error_norm,
            p.options.pi_control_integral, p.options.pi_control_proportional,
            self.order + 1,
        )
        factor = clamp_factor(
            0.9 * raw,
            cfg.minimum_timestep_shrink, cfg.maximum_timestep_shrink,
            cfg.minimum_timestep_growth, cfg.maximum_timestep_growth,
        )

        failed = status < 0
        g_new = (
            state.g + lincomb(np.asarray(tab.b), gdiff)
            if p.integrate_out else state.g
        )
        t_new = state.t + h

        sens_upd = {}
        if self.sens:
            sens_upd = dict(
                s=carry["s_new"], ds=carry["ds_new"], sdiff=carry["sdiff"],
                s_prev=state.s,
            )
        new_state = state.replace(
            y=y_new, dy=dy_new, g=g_new, t=t_new, h=h * factor,
            y_prev=state.y, dy_prev=state.dy, g_prev=state.g, t_prev=state.t,
            diff=diff, gdiff=gdiff,
            prev_error_norm=err,
            root_g=root_g,
            state_modified=jnp.asarray(False),
            stats=state.stats._replace(
                steps=state.stats.steps + 1,
                error_test_failures=state.stats.error_test_failures + natt,
                worst_member=carry["wm"],
                # s-1 stage rhs evaluations per attempt (stage 0 is FSAL
                # from dy) -- OpStatistics number_of_calls
                rhs_evals=state.stats.rhs_evals
                + (tab.s - 1) * (natt + 1),
            ),
            **sens_upd,
        )

        # root check inside the accepted step
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

        # tstop check
        reached, h_adj = tstop_check(t_new, new_state.h, state.tstop, dtype)
        stop = jnp.where(
            (stop == errors.INTERNAL_TIMESTEP) & reached, errors.TSTOP_REACHED, stop
        ).astype(jnp.int32)
        new_state = new_state.replace(
            h=h_adj, status=stop, root_t=root_t, root_idx=root_idx
        )

        # on fatal error, keep the old state but record the status
        return jax.tree_util.tree_map(
            lambda new, old: jnp.where(failed, old, new), new_state, state
        ).replace(status=jnp.where(failed, status, new_state.status).astype(jnp.int32))

    # ------------------------------------------------------------------
    def interpolate(self, state: RkState, t):
        return interp_y(self.tableau, state, t)

    def interpolate_dy(self, state: RkState, t):
        return interp_dy(self.tableau, state, t)

    def interpolate_out(self, state: RkState, t):
        return interp_out(self.tableau, state, t)

    def interpolate_sens(self, state: RkState, t):
        return interp_sens(self.tableau, state, t)
