"""Variable-order BDF/NDF stepper (orders 1-5, ode15s/SciPy style).

Re-design of the reference BDF solver
(reference crates/diffsol/src/ode_solver/bdf.rs:111-1650, bdf_state.rs,
op/bdf.rs): the entire adaptive step -- prediction from the backward
difference matrix D, Newton correction against the frozen LU of
``M - c*J`` (c = h*alpha_k), WRMS error test, PI step-size control,
R(factor)*U rescaling of D on step-size changes, order selection after k+1
equal steps, the Jacobian-update policy and the convergence-failure ladder
(1st failure: refresh Jacobian; 2nd: h *= 0.3) -- is traced arithmetic and
``lax.cond``/``lax.while_loop`` control flow, so whole solves compile to one
XLA program and ``vmap`` over params gives batched ensemble solving with
per-member adaptive control flow.

NDF coefficients from Shampine & Reichelt (the MATLAB ode15s paper):
kappa = [0, -0.1850, -1/9, -0.0823, -0.0415, 0] (bdf.rs:253-260).

One deliberate deviation from the reference: the accepted state ``y`` is the
CORRECTED solution (D[0] after the difference update, as in SciPy), whereas
reference bdf.rs:1474 keeps the predictor; the two differ by less than the
local error tolerance.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import errors
from ..norms import squared_norm, squared_norm_and_worst
from ..ops.controller import pi_controller_raw
from ..ops.newton import ETA_RESET_JACOBIAN, ETA_RESET_TIMESTEP, newton_solve
from ..ops.rootfind import check_root
from ..problem import OdeProblem, SolverConfig
from .._pytree import pytree_dataclass
from .consistent_ic import algebraic_mask, make_consistent
from .rk_common import Stats
from .state import initial_state, initial_step_size
from ..precision import highest_precision

MAX_ORDER = 5
ND = MAX_ORDER + 3  # rows of the difference matrix D

# static NDF coefficient tables (bdf.rs:253-276)
_KAPPA = np.array([0.0, -0.1850, -1.0 / 9.0, -0.0823, -0.0415, 0.0])
_GAMMA = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, MAX_ORDER + 1))])
_ALPHA = np.concatenate([[0.0], 1.0 / ((1.0 - _KAPPA[1:]) * _GAMMA[1:])])
# error_const2[i] = (kappa[i]*gamma[i] + 1/(i+1))^2, error_const2[0] = 1
_ERROR_CONST2 = np.concatenate(
    [[1.0], (_KAPPA[1:] * _GAMMA[1:] + 1.0 / np.arange(2, MAX_ORDER + 2)) ** 2]
)

# solver-state kinds for the Jacobian-update policy (jacobian_update.rs:4-10)
_STEP_SUCCESS = 0
_FIRST_CONV_FAIL = 1
_SECOND_CONV_FAIL = 2
_ERROR_TEST_FAIL = 3
_CHECKPOINT = 4


@pytree_dataclass
class BdfState:
    """Complete restartable BDF snapshot (reference BdfState, bdf_state.rs).

    ``D`` is the (ND, n) backward-difference matrix (rows 0..order+2 in use);
    ``gD`` the quadrature difference matrix.  Jacobian/LU, Newton eta memory
    and the Jacobian-update counters ride along so a solve is a single
    while-loop over this pytree.  Sensitivity fields are None unless enabled.
    """

    y: jax.Array
    dy: jax.Array
    g: jax.Array
    t: jax.Array
    h: jax.Array
    D: jax.Array  # (ND, n)
    gD: jax.Array  # (ND, nout)
    order: jax.Array  # int32 in [1, MAX_ORDER]
    n_equal_steps: jax.Array  # int32
    jac: jax.Array
    factors: tuple
    eta: jax.Array
    prev_error_norm: jax.Array  # NaN = none
    steps_since_jac: jax.Array  # int32
    steps_since_rhs_jac: jax.Array  # int32
    c_last: jax.Array  # c at last Jacobian update
    newton_fails_total: jax.Array  # int32 (cumulative, bdf.rs:1366)
    root_g: jax.Array
    tstop: jax.Array
    status: jax.Array
    root_t: jax.Array
    root_idx: jax.Array
    state_modified: jax.Array
    stats: Stats
    # forward sensitivities (None unless enabled)
    s: Optional[jax.Array] = None  # (nparams, n)
    sD: Optional[jax.Array] = None  # (nparams, ND, n)


def _compute_ru(order, factor, dtype):
    """(ND, ND) matrix RU = R(factor) @ R(1) acting on D rows 0..order
    (bdf.rs:433-463 `_compute_r`); identity on the untouched tail rows.

    r[i, j] = prod_{m=1..i} (m - 1 - factor*j)/m (r[0, j] = 1).
    """
    i = jnp.arange(ND, dtype=dtype)[:, None]
    j = jnp.arange(ND, dtype=dtype)[None, :]

    def r_mat(f):
        m = jnp.arange(1, ND, dtype=dtype)[:, None]
        terms = (m - 1.0 - f * j) / m  # (ND-1, ND)
        rows = jnp.concatenate([jnp.ones((1, ND), dtype), terms], axis=0)
        return jnp.cumprod(rows, axis=0)

    r = r_mat(jnp.asarray(factor, dtype))
    u = r_mat(jnp.asarray(1.0, dtype))
    valid = (i <= order) & (j <= order)
    eye = jnp.eye(ND, dtype=dtype)
    r = jnp.where(valid, r, eye)
    u = jnp.where(valid, u, eye)
    return r @ u


# The three D-matrix transforms below are UNROLLED over the ND=8 static rows
# as masked elementwise FMAs instead of tensordots over the leading row axis
# of an (8, n, B) array: the row chains fuse into a few elementwise kernels.


def _apply_ru(ru, D):
    """D <- RU^T @ D as ND row-broadcast FMAs (one fused elementwise
    kernel instead of a contraction over the leading row axis)."""
    shape = (ND,) + (1,) * (D.ndim - 1)
    acc = ru[0].reshape(shape) * D[0]
    for i in range(1, ND):
        acc = acc + ru[i].reshape(shape) * D[i]
    return acc


def _predict_from_diff(D, order):
    """y_pred = sum_{i=0..order} D[i] (bdf.rs:667-672)."""
    acc = D[0]
    for i in range(1, MAX_ORDER + 1):
        acc = acc + jnp.where(i <= order, D[i], jnp.zeros((), D.dtype))
    return acc


def _psi(D, order, dtype):
    """psi = alpha[order] * sum_{i=1..order} gamma[i] * D[i] (op/bdf.rs:182-196)."""
    gamma = _GAMMA
    acc = jnp.asarray(gamma[1], dtype) * D[1]
    for i in range(2, MAX_ORDER + 1):
        w = jnp.where(i <= order, jnp.asarray(gamma[i], dtype), 0.0)
        acc = acc + w * D[i]
    alpha_k = jnp.asarray(_ALPHA, dtype)[order]
    return alpha_k * acc


def _update_diff(D, d, order):
    """Difference update after an accepted step (bdf.rs:646-665):
    D[order+2] = d - D[order+1]; D[order+1] = d; D[i] += D[i+1] downward.
    Equivalently D'[i] = sum_{k=i..order} D[k] + d for i <= order."""
    zero = jnp.zeros((), D.dtype)
    d_old_op1 = jax.lax.dynamic_index_in_dim(
        D, order + 1, axis=0, keepdims=False
    )
    # suffix[i] = sum_{k=i..order} D[k], accumulated top-down
    new_rows = [None] * ND
    acc = jnp.zeros_like(D[0])
    for i in range(ND - 1, -1, -1):
        acc = acc + jnp.where(i <= order, D[i], zero)
        below = acc + d  # rows i <= order
        new_rows[i] = jnp.where(
            i <= order,
            below,
            jnp.where(
                i == order + 1,
                d,
                jnp.where(i == order + 2, d - d_old_op1, D[i]),
            ),
        )
    return jnp.stack(new_rows)


def _interp_from_diff(t, D, t1, h, order):
    """Interpolation polynomial from D (bdf.rs:767-790)."""
    dtype = D.dtype
    y = D[0]
    time_factor = jnp.asarray(1.0, dtype)
    for i in range(MAX_ORDER):
        fi = jnp.asarray(float(i), dtype)
        tf = time_factor * (t - (t1 - h * fi)) / (h * (1.0 + fi))
        contrib = jnp.where(i < order, tf, 0.0)
        y = y + contrib * D[i + 1]
        time_factor = jnp.where(i < order, tf, time_factor)
    return y


def _interp_deriv_from_diff(t, D, t1, h, order):
    """d/dt of the interpolation polynomial (bdf.rs:792-810)."""
    dtype = D.dtype
    dy = jnp.zeros_like(D[0])
    pi = jnp.asarray(1.0, dtype)
    d_pi = jnp.asarray(0.0, dtype)
    for i in range(MAX_ORDER):
        fi = jnp.asarray(float(i), dtype)
        denom = h * (1.0 + fi)
        w = (t - (t1 - h * fi)) / denom
        dw = 1.0 / denom
        new_d_pi = d_pi * w + pi * dw
        use = i < order
        contrib = jnp.where(use, new_d_pi, 0.0)
        dy = dy + contrib * D[i + 1]
        pi = jnp.where(use, pi * w, pi)
        d_pi = jnp.where(use, new_d_pi, d_pi)
    return dy


class BdfSolver:
    """Variable-order NDF/BDF method on an :class:`OdeProblem`."""

    def __init__(
        self,
        problem: OdeProblem,
        config: Optional[SolverConfig] = None,
        sens: bool = False,
        augmented=None,
    ):
        self.problem = problem
        self.config = config or SolverConfig.from_options(problem.options, "bdf")
        # static partition of algebraic states (zero mass diagonal)
        self._alg_mask = algebraic_mask(problem)
        self._nb = problem.lockstep_nbatch
        # augmented equation sets integrated in lockstep with the main
        # system (reference AugmentedOdeEquations; sens=True installs the
        # continuous SensEquations, bdf.rs:934-989 sensitivity_solve)
        if augmented is None and sens:
            from ..augmented import SensEquations

            augmented = SensEquations(problem)
        self.aug = augmented
        self.sens = augmented is not None
        self.has_sens = self.sens
        # JVP probes per Jacobian evaluation, for the OpStatistics
        # jac_mul_evals counter (n dense jacfwd; tier jacs carry their own
        # probe count as a .jvp_probes attribute)
        self._jvp_probes = getattr(
            problem.eqn.rhs_jac, "jvp_probes", problem.eqn.nstates
        )

    def with_config(self, config: SolverConfig):
        """Mid-run configuration change (reference method.rs:84
        `config_mut`): returns a NEW solver over the same problem and
        augmented equations; continue by passing the previous solve's
        restartable ``state`` to the next driver call."""
        return type(self)(self.problem, config=config, augmented=self.aug)

    # ------------------------------------------------------------------
    # augmented rows: M s_i' = J s_i + forcing_i, all rows at once
    def _sens_rhs_parts(self, t, y, params):
        return self.aug.linear_parts(t, y, params)

    def _sens_mass_rows(self, t, params, S):
        return self.aug.mass_rows(self.problem, t, params, S)

    def _sens_solve(self, t_pred, y_ctx, params, cval, sD, order, factors, eta):
        """Solve all augmented systems sharing the factorized M - c*J
        (bdf.rs:934-989).  Returns (s_delta (naug,n), ok, niter)."""
        p = self.problem
        dtype = y_ctx.dtype
        jvp_rows, f_p = self.aug.linear_parts(t_pred, y_ctx, params)
        s_pred = jax.vmap(lambda Drows: _predict_from_diff(Drows, order))(sD)
        psi_s = jax.vmap(lambda Drows: _psi(Drows, order, dtype))(sD)

        def residual(S):
            rhs_s = jvp_rows(S) + f_p
            tmp = S - s_pred + psi_s
            return self._sens_mass_rows(t_pred, params, tmp) - cval * rhs_s

        lin_solve = lambda V: p.linear_solver.solve(factors, V)
        res = newton_solve(
            residual, lin_solve, s_pred, s_pred,
            self.aug.atol(p), self.aug.rtol(p), eta,
            tol=p.options.nonlinear_solver_tolerance,
            max_iter=self.config.maximum_newton_iterations,
            nbatch=self._nb,
        )
        return res.x - s_pred, res.converged, res.niter

    @property
    def order(self) -> int:
        return MAX_ORDER

    # ------------------------------------------------------------------
    # operator pieces
    # ------------------------------------------------------------------
    def _mass_matrix(self, t, params):
        return self.problem.eqn.mass_matrix(t, params)

    def _mass_mul(self, t, params, v):
        return self.problem.eqn.mass_mul(t, params, v)

    def _assemble_and_factor(self, t, y, params, c, stats):
        """Evaluate J = df/dy at (t, y), assemble M - c*J and factorize."""
        p = self.problem
        jac = p.eqn.jac(t, y, params)
        mass = p.eqn.mass_repr(t, params)
        a = p.linear_solver.assemble(mass, jac, c)
        factors = p.linear_solver.factor(a)
        stats = stats._replace(
            jacobian_evals=stats.jacobian_evals + 1,
            linear_solver_setups=stats.linear_solver_setups + 1,
            jac_mul_evals=stats.jac_mul_evals + self._jvp_probes,
            mass_evals=stats.mass_evals + int(p.eqn.mass is not None),
        )
        return jac, factors, stats

    def _refactor(self, t, params, jac, c, stats):
        """Re-factorize M - c*J with the existing (possibly stale) J."""
        p = self.problem
        mass = p.eqn.mass_repr(t, params)
        a = p.linear_solver.assemble(mass, jac, c)
        factors = p.linear_solver.factor(a)
        stats = stats._replace(linear_solver_setups=stats.linear_solver_setups + 1)
        return factors, stats

    def _jac_slim(
        self, jac, factors, stats, eta, ssj, ssrj, c_last,
        t, y, params, c, rhs_pred, jac_pred, causes=None,
    ):
        """Jacobian-update policy (bdf.rs:467-505 + jacobian_update.rs) with a
        SLIM cond payload: only (jac, factors) ride the conditional; all the
        scalar bookkeeping is unconditional select arithmetic.

        ``rhs_pred`` requests a full Jacobian re-evaluation + factorization;
        ``jac_pred`` a re-factorization of ``M - c*J`` with the stale J.
        Callers compute the predicates from the reference kind tables.

        Rationale: a lax.cond whose branches return the whole solver carry
        copies megabytes per step attempt at a 10k-member ensemble; paying
        only the (jac, factors) copy makes the common no-update path
        nearly free.
        """
        p = self.problem
        do_any = rhs_pred | jac_pred

        def update(args):
            jac0, factors0 = args
            jac1 = jax.lax.cond(
                rhs_pred,
                lambda _: p.eqn.jac(t, y, params),
                lambda _: jac0,
                None,
            )
            mass = p.eqn.mass_repr(t, params)
            a = p.linear_solver.assemble(mass, jac1, c)
            return jac1, p.linear_solver.factor(a)

        jac, factors = jax.lax.cond(
            do_any, update, lambda args: args, (jac, factors)
        )
        i32 = jnp.int32
        ssj = jnp.where(do_any, 0, ssj).astype(i32)
        ssrj = jnp.where(rhs_pred, 0, ssrj).astype(i32)
        c_last = jnp.where(do_any, c, c_last)
        eta = jnp.where(do_any, ETA_RESET_JACOBIAN, eta).astype(eta.dtype)
        upd = dict(
            linear_solver_setups=stats.linear_solver_setups
            + do_any.astype(i32),
            jacobian_evals=stats.jacobian_evals + rhs_pred.astype(i32),
            jac_mul_evals=stats.jac_mul_evals
            + rhs_pred.astype(i32) * self._jvp_probes,
            mass_evals=stats.mass_evals
            + do_any.astype(i32) * int(p.eqn.mass is not None),
        )
        if causes is not None:
            # per-cause LU-setup breakdown (ode_solver/mod.rs:53-70)
            names = (
                "lu_from_checkpoint", "lu_from_first_fail",
                "lu_from_second_fail", "lu_from_error_test",
                "lu_from_step_success",
            )
            for name, flag in zip(names, causes):
                inc = (do_any & jnp.asarray(flag)).astype(i32)
                upd[name] = getattr(stats, name) + inc
        stats = stats._replace(**upd)
        return jac, factors, stats, eta, ssj, ssrj, c_last

    # ------------------------------------------------------------------
    @highest_precision
    def init_state(self, params=None) -> BdfState:
        p = self.problem
        params = p.params if params is None else params
        y, dy, g, dg = initial_state(p, params)
        ic_status = jnp.asarray(errors.INTERNAL_TIMESTEP, jnp.int32)
        if self._alg_mask is not None:
            y, dy, ic_status = make_consistent(p, params, y, dy, self._alg_mask)
        h = initial_step_size(p, params, y, dy, 1)
        dtype = y.dtype
        n = y.shape[-1]
        D = jnp.zeros((ND,) + y.shape, dtype)
        D = D.at[0].set(y).at[1].set(h * dy)
        gD = jnp.zeros((ND,) + g.shape, dtype)
        if p.integrate_out:
            gD = gD.at[0].set(g).at[1].set(h * dg)
        c0 = h * jnp.asarray(_ALPHA, dtype)[1]
        stats = Stats.zeros()
        jac, factors, stats = self._assemble_and_factor(
            jnp.asarray(p.t0, dtype), y, params, c0, stats
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
        s_f = sD_f = None
        if self.sens:
            t0 = jnp.asarray(p.t0, dtype)
            s_f, ds0 = self.aug.init(t0, y, dy, params)
            if self._alg_mask is not None and hasattr(self.aug, "consistent_init"):
                # sens-consistent DAE rows (reference state.rs:167-239,
                # :1032 new_with_sensitivities_and_consistent)
                s_f, ds0 = self.aug.consistent_init(
                    t0, y, dy, params, s_f, self._alg_mask
                )
            sD_f = jnp.zeros((s_f.shape[0], ND) + y.shape, dtype)
            sD_f = sD_f.at[:, 0].set(s_f).at[:, 1].set(h * ds0)
        return BdfState(
            y=y, dy=dy, g=g, t=jnp.asarray(p.t0, dtype), h=h,
            D=D, gD=gD, s=s_f, sD=sD_f,
            order=jnp.asarray(1, jnp.int32),
            n_equal_steps=jnp.asarray(0, jnp.int32),
            jac=jac, factors=factors,
            eta=jnp.asarray(ETA_RESET_JACOBIAN, dtype),
            prev_error_norm=nan,
            steps_since_jac=jnp.asarray(0, jnp.int32),
            steps_since_rhs_jac=jnp.asarray(0, jnp.int32),
            c_last=c0,
            newton_fails_total=jnp.asarray(0, jnp.int32),
            root_g=root_g, tstop=nan,
            status=ic_status,
            root_t=nan, root_idx=jnp.asarray(-1, jnp.int32),
            state_modified=jnp.asarray(False),
            stats=stats,
        )

    def reinit_after_reset(self, state: BdfState, params) -> BdfState:
        """Refresh dy (and re-solve DAE consistency) after a reset
        (reference state.rs apply_reset_with_mass)."""
        p = self.problem
        dy = p.eqn.rhs(state.t, state.y, params)
        if self._alg_mask is None:
            return state.replace(dy=dy)
        y, dy, status = make_consistent(
            p, params, state.y, dy, self._alg_mask, t=state.t
        )
        return state.replace(y=y, dy=dy, status=status)

    def set_stop_time(self, state: BdfState, tstop) -> BdfState:
        tstop = jnp.asarray(tstop, state.t.dtype)
        state = state.replace(tstop=tstop)
        # adjust h (rescaling D) if the next step would overshoot
        reached, state = self._handle_tstop_pre(state)
        from .state import _flag_past_tstop

        return _flag_past_tstop(state, tstop)

    def _handle_tstop_pre(self, state: BdfState):
        """tstop handling (bdf.rs:694-731): returns (reached, state)."""
        dtype = state.t.dtype
        eps = jnp.finfo(dtype).eps
        tstop = state.tstop
        have = ~jnp.isnan(tstop)
        troundoff = 100.0 * eps * (jnp.abs(state.t) + jnp.abs(state.h))
        reached = have & (jnp.abs(state.t - tstop) <= troundoff)
        fwd = state.h > 0.0
        overshoot = have & ~reached & jnp.where(
            fwd,
            state.t + state.h > tstop + troundoff,
            state.t + state.h < tstop - troundoff,
        )
        factor = jnp.where(overshoot, (tstop - state.t) / state.h, 1.0)

        def rescale(s):
            D, gD, sD, h = self._rescale_all(s.D, s.gD, s.sD, s.h, s.order, factor)
            upd = dict(sD=sD) if sD is not None else {}
            return s.replace(
                D=D, gD=gD, h=h,
                n_equal_steps=jnp.asarray(0, jnp.int32),
                eta=jnp.asarray(ETA_RESET_TIMESTEP, dtype),
                **upd,
            )

        state = jax.lax.cond(overshoot, rescale, lambda s: s, state)
        return reached, state

    def _rescale_step(self, D, h, order, factor):
        """h *= factor and D[0..order+1] <- (R(factor) U)^T D (bdf.rs:508-577)."""
        ru = _compute_ru(order, factor, D.dtype)
        return _apply_ru(ru, D), h * factor, ru

    def _rescale_all(self, D, gD, sD, h, order, factor):
        """Rescale every difference matrix for a step-size change."""
        ru = _compute_ru(order, factor, D.dtype)
        D = _apply_ru(ru, D)
        gD = _apply_ru(ru, gD)
        if sD is not None:
            sD = jax.vmap(lambda Dr: _apply_ru(ru, Dr))(sD)
        return D, gD, sD, h * factor

    # ------------------------------------------------------------------
    def _residual(self, t_pred, y_pred, psi, params, c):
        p = self.problem

        def residual(x):
            fx = p.eqn.rhs(t_pred, x, params)
            tmp = x - y_pred + psi
            return p.eqn.mass_mul(t_pred, params, tmp) - c * fx

        return residual

    @highest_precision
    def step(self, state: BdfState, params=None) -> BdfState:
        """One adaptive BDF step (bdf.rs:1277-1650).

        Program-structure note: the step is STRAIGHT-LINE traced
        arithmetic with `jnp.where` scalar control; `lax.cond` appears only
        where it skips genuinely heavy work (Jacobian refresh / LU refactor,
        D-matrix rescaling, order-selection norms) and each such cond carries
        the minimal payload, so the step is few, large kernels rather than
        the reference's branch-heavy control flow.
        """
        p = self.problem
        cfg = self.config
        opts = p.options
        params = p.params if params is None else params
        dtype = state.y.dtype
        alpha = jnp.asarray(_ALPHA, dtype)
        ec2 = jnp.asarray(_ERROR_CONST2, dtype)
        max_newton = cfg.maximum_newton_iterations
        integrate_out = p.integrate_out
        i32 = jnp.int32
        nan = jnp.asarray(jnp.nan, dtype)
        eps = jnp.finfo(dtype).eps

        def predict(D, order):
            return _predict_from_diff(D, order), _psi(D, order, dtype)

        # ---- maskless state-modified reinitialisation (bdf.rs:1291-1319) --
        # After a reset/pin-back the difference matrix restarts at order 1.
        # At order 1 the tstop-overshoot D-rescale is exactly h *= factor, so
        # the reference's reinit (rebuild D, jacobian update, tstop clamp)
        # folds into unconditional select arithmetic.
        modified = state.state_modified
        tstop = state.tstop
        have_tstop = ~jnp.isnan(tstop)
        tr0 = 100.0 * eps * (jnp.abs(state.t) + jnp.abs(state.h))
        reached0 = have_tstop & (jnp.abs(state.t - tstop) <= tr0)
        fwd = state.h > 0.0
        overshoot0 = have_tstop & ~reached0 & jnp.where(
            fwd,
            state.t + state.h > tstop + tr0,
            state.t + state.h < tstop - tr0,
        )
        h_re = jnp.where(modified & overshoot0, tstop - state.t, state.h)
        h0 = jnp.where(modified, h_re, state.h)
        D_re = (
            jnp.zeros_like(state.D).at[0].set(state.y).at[1].set(h_re * state.dy)
        )
        D0 = jnp.where(modified, D_re, state.D)
        gD0 = state.gD
        if integrate_out:
            dg0 = (
                p.eqn.out(state.t, state.y, params)
                if p.eqn.out is not None
                else state.y
            )
            gD_re = (
                jnp.zeros_like(state.gD).at[0].set(state.g).at[1].set(h_re * dg0)
            )
            gD0 = jnp.where(modified, gD_re, state.gD)
        sD0 = state.sD
        if self.sens:
            jvp_rows0, f_p0 = self._sens_rhs_parts(state.t, state.y, params)
            ds0 = jvp_rows0(state.s) + f_p0
            sD_re = (
                jnp.zeros_like(state.sD)
                .at[:, 0].set(state.s)
                .at[:, 1].set(h_re * ds0)
            )
            sD0 = jnp.where(modified, sD_re, state.sD)
        order = jnp.where(modified, 1, state.order).astype(i32)
        n_equal0 = jnp.where(modified, 0, state.n_equal_steps).astype(i32)
        prev_err0 = jnp.where(modified, nan, state.prev_error_norm)
        # root_g is root(t, y) at the current point in ALL cases (after an
        # accepted step it was stored as exactly that), so an unconditional
        # recompute is both correct and branch-free
        root_g0 = (
            p.eqn.root(state.t, state.y, params)
            if p.eqn.root is not None
            else state.root_g
        )
        # reinit jacobian policy (kind StepSuccess, as before the rewrite)
        c1 = state.h * alpha[1]
        rel1 = jnp.abs(c1 / state.c_last - 1.0)
        rhs_pred0 = modified & (
            state.steps_since_rhs_jac >= opts.update_rhs_jacobian_after_steps
        )
        jac_pred0 = modified & (
            (state.steps_since_jac >= opts.update_jacobian_after_steps)
            | (rel1 > opts.threshold_to_update_jacobian)
        )
        jac0, factors0, stats0, eta0, ssj0, ssrj0, c_last0 = self._jac_slim(
            state.jac, state.factors, state.stats, state.eta,
            state.steps_since_jac, state.steps_since_rhs_jac, state.c_last,
            state.t, state.y, params, c1, rhs_pred0, jac_pred0,
            causes=(True, False, False, False, False),
        )
        eta0 = jnp.where(modified & overshoot0, ETA_RESET_TIMESTEP, eta0)

        # ---- accept loop (bdf.rs:1324-1465): one iteration per attempt ----
        y_pred0, psi0 = predict(D0, order)
        carry0 = dict(
            jac=jac0, factors=factors0, eta=eta0, stats=stats0,
            ssj=ssj0, ssrj=ssrj0, c_last=c_last0,
            D=D0, gD=gD0, sD=sD0, h=h0,
            y_pred=y_pred0, psi=psi0,
            d=jnp.zeros_like(state.y),
            g_delta=jnp.zeros_like(state.g),
            s_delta=None if sD0 is None else jnp.zeros_like(state.s),
            conv_fail=jnp.asarray(False),
            err=jnp.asarray(jnp.inf, dtype),
            safety=jnp.asarray(1.0, dtype),
            prev_err=prev_err0,
            newton_fails=state.newton_fails_total,
            err_fails_step=jnp.asarray(0, i32),
            accepted=jnp.asarray(False),
            h_changed=jnp.asarray(False),
            status=jnp.asarray(errors.INTERNAL_TIMESTEP, i32),
        )

        def attempt_cond(c):
            return (~c["accepted"]) & (c["status"] == errors.INTERNAL_TIMESTEP)

        def attempt_body(c):
            cval = c["h"] * alpha[order]
            t_pred = state.t + c["h"]
            residual = self._residual(t_pred, c["y_pred"], c["psi"], params, cval)
            lin_solve = lambda v: p.linear_solver.solve(c["factors"], v)
            res = newton_solve(
                residual, lin_solve, c["y_pred"], c["y_pred"],
                p.atol, p.rtol, c["eta"],
                tol=opts.nonlinear_solver_tolerance, max_iter=max_newton,
                nbatch=self._nb,
            )
            d = res.x - c["y_pred"]
            niter_total = res.niter

            # sensitivity solve sharing the factorization (bdf.rs:934-989)
            if self.sens:
                s_delta, sens_ok, s_niter = self._sens_solve(
                    t_pred, c["y_pred"], params, cval, c["sD"], order,
                    c["factors"], c["eta"],
                )
                solve_ok = res.converged & sens_ok
                niter_total = niter_total + s_niter
            else:
                s_delta = c["s_delta"]
                solve_ok = res.converged

            # quadrature delta (op/bdf.rs:45-57: d_g = c*dg - psi_g)
            if integrate_out:
                dg = (
                    p.eqn.out(t_pred, c["y_pred"], params)
                    if p.eqn.out is not None
                    else c["y_pred"]
                )
                psi_g = _psi(c["gD"], order, dtype)
                g_delta = cval * dg - psi_g
            else:
                g_delta = c["g_delta"]

            # ---- unconditional error test (junk when ~solve_ok, unused) ----
            sq_d, wm_new = squared_norm_and_worst(
                d, state.y, p.atol, p.rtol, self._nb
            )
            err = sq_d * ec2[order - 1]
            if p.output_in_error_control():
                err = jnp.maximum(
                    err,
                    squared_norm(
                        g_delta, state.g, p.out_atol, p.out_rtol, self._nb
                    )
                    * ec2[order],
                )
            if self.sens and p.sens_in_error_control():
                s_errs = jax.vmap(
                    lambda sd, sv: squared_norm(
                        sd, sv, p.sens_atol, p.sens_rtol, self._nb
                    )
                )(s_delta, state.s)
                err = jnp.maximum(err, jnp.max(s_errs) * ec2[order])
            accepted = solve_ok & (err <= 1.0)
            # keep the previous culprit on nonlinear-solver failure: d from
            # an unconverged/diverged Newton iterate is junk (NaN argmax
            # would confidently name member 0)
            wm = jnp.where(solve_ok, wm_new, c["stats"].worst_member)
            m = float(max_newton)
            safety = 0.9 * (2.0 * m + 1.0) / (2.0 * m + res.niter.astype(dtype))

            # ---- scalar failure/rejection control (all selects) ----
            first = (~solve_ok) & ~c["conv_fail"]
            second = (~solve_ok) & c["conv_fail"]
            err_fail = solve_ok & ~accepted
            newton_fails = c["newton_fails"] + (~solve_ok).astype(i32)
            too_many = (~solve_ok) & (newton_fails > cfg.maximum_newton_fails)
            raw = pi_controller_raw(
                err, c["prev_err"],
                opts.pi_control_integral, opts.pi_control_proportional,
                order + 1,
            )
            rej_factor = jnp.maximum(safety * raw, cfg.minimum_timestep_shrink)
            # error-test reject: PI factor; 2nd Newton failure: h *= 0.3
            factor = jnp.where(
                err_fail, rej_factor, jnp.asarray(0.3, dtype)
            )
            do_rescale = err_fail | second
            h_new = c["h"] * jnp.where(do_rescale, factor, 1.0)

            # jacobian-update predicates per failure kind
            # (jacobian_update.rs: FIRST -> rhs if |c/c_last-1| below thresh;
            # SECOND -> rhs if any rhs-jac age; ERROR_TEST -> refactor only;
            # every failure kind triggers at least a refactor)
            c_jac = h_new * alpha[order]
            rel = jnp.abs(c_jac / c["c_last"] - 1.0)
            rhs_pred = (
                first & (rel < opts.threshold_to_update_rhs_jacobian)
            ) | (second & (c["ssrj"] > 0))
            stats = c["stats"]._replace(
                newton_iterations=c["stats"].newton_iterations + niter_total,
                newton_fails=c["stats"].newton_fails + (~solve_ok).astype(i32),
                error_test_failures=c["stats"].error_test_failures
                + err_fail.astype(i32),
                worst_member=wm,
                # one residual rhs evaluation per Newton iteration
                # (OpStatistics number_of_calls, op/mod.rs)
                rhs_evals=c["stats"].rhs_evals + niter_total,
            )
            jac, factors, stats, eta, ssj, ssrj, c_last = self._jac_slim(
                c["jac"], c["factors"], stats, res.eta,
                c["ssj"], c["ssrj"], c["c_last"],
                state.t, state.y, params, c_jac, rhs_pred, ~accepted,
                causes=(False, first, second, err_fail, False),
            )

            # ---- D rescale + re-predict, slim cond (bdf.rs:508-577) ----
            def do_resc(args):
                D, gD, sD, _yp, _psi = self._unpack5(args)
                D2, gD2, sD2, _h = self._rescale_all(D, gD, sD, c["h"], order, factor)
                y_p2, psi2 = predict(D2, order)
                return self._pack5(D2, gD2, sD2, y_p2, psi2)

            packed = jax.lax.cond(
                do_rescale,
                do_resc,
                lambda a: a,
                self._pack5(c["D"], c["gD"], c["sD"], c["y_pred"], c["psi"]),
            )
            D, gD, sD, y_pred, psi = self._unpack5(packed)

            # ---- status ladder (precedence mirrors the branch ordering) ----
            err_fails_step = c["err_fails_step"] + err_fail.astype(i32)
            status = c["status"]
            status = jnp.where(
                err_fail & (err_fails_step >= cfg.maximum_error_test_failures),
                errors.TOO_MANY_ERROR_TEST_FAILURES, status,
            )
            status = jnp.where(
                do_rescale & (jnp.abs(h_new) < cfg.minimum_timestep),
                errors.STEP_SIZE_TOO_SMALL, status,
            )
            status = jnp.where(
                too_many, errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES, status
            ).astype(i32)

            return dict(
                jac=jac, factors=factors, eta=eta, stats=stats,
                ssj=ssj, ssrj=ssrj, c_last=c_last,
                D=D, gD=gD, sD=sD, h=h_new,
                y_pred=y_pred, psi=psi,
                d=d, g_delta=g_delta, s_delta=s_delta,
                conv_fail=c["conv_fail"] | ~solve_ok,
                err=jnp.where(solve_ok, err, c["err"]),
                safety=jnp.where(solve_ok, safety, c["safety"]),
                prev_err=jnp.where(accepted, c["prev_err"], nan),
                newton_fails=newton_fails,
                err_fails_step=err_fails_step,
                accepted=accepted,
                h_changed=c["h_changed"] | do_rescale,
                status=status,
            )

        carry = jax.lax.while_loop(attempt_cond, attempt_body, carry0)
        failed = carry["status"] != errors.INTERNAL_TIMESTEP

        # ---- accepted step (bdf.rs:1469-1486) ----
        D_new = _update_diff(carry["D"], carry["d"], order)
        y_new = D_new[0]  # = y_pred + d (corrected)
        t_new = state.t + carry["h"]
        dy_new = D_new[1] / carry["h"]
        if self.sens:
            sD_new = jax.vmap(lambda Dr, dr: _update_diff(Dr, dr, order))(
                carry["sD"], carry["s_delta"]
            )
            s_new = sD_new[:, 0]
        else:
            sD_new = carry["sD"]
            s_new = state.s
        if integrate_out:
            g_new = _predict_from_diff(carry["gD"], order) + carry["g_delta"]
            gD_new = _update_diff(carry["gD"], carry["g_delta"], order)
        else:
            g_new = state.g
            gD_new = carry["gD"]

        stats = carry["stats"]._replace(steps=carry["stats"].steps + 1)
        ssj = carry["ssj"] + 1
        ssrj = carry["ssrj"] + 1
        eta = carry["eta"]
        c_last = carry["c_last"]
        jac = carry["jac"]
        factors = carry["factors"]
        err = carry["err"]
        # a step-size change during the attempt loop resets the equal-step
        # counter (reference _update_step_size, bdf.rs:508-519)
        n_equal = jnp.where(carry["h_changed"], 1, n_equal0 + 1).astype(i32)

        # ---- order selection (bdf.rs:1489-1562): scalar-payload decision --
        def order_decide(_):
            def predicted_err(col, const_idx):
                e = squared_norm(
                    jnp.take(D_new, col, axis=0), y_new, p.atol, p.rtol, self._nb
                ) * ec2[const_idx]
                if self.sens and p.sens_in_error_control():
                    se = jax.vmap(
                        lambda Dr, sv: squared_norm(
                            jnp.take(Dr, col, axis=0), sv,
                            p.sens_atol, p.sens_rtol, self._nb
                        )
                    )(sD_new, s_new)
                    e = jnp.maximum(e, jnp.max(se) * ec2[const_idx])
                return e

            em = jnp.where(
                order > 1,
                predicted_err(order, jnp.maximum(order - 1, 0)),
                jnp.inf,
            )
            ep = jnp.where(
                order < MAX_ORDER,
                predicted_err(order + 2, jnp.minimum(order + 1, MAX_ORDER)),
                jnp.inf,
            )
            prev = err  # bdf.rs sets prev_error_norm = err before this block
            pi_i, pi_p = opts.pi_control_integral, opts.pi_control_proportional
            f_m = pi_controller_raw(em, prev, pi_i, pi_p, order)
            f_0 = pi_controller_raw(err, prev, pi_i, pi_p, order + 1)
            f_p = pi_controller_raw(ep, prev, pi_i, pi_p, order + 2)
            factors3 = jnp.stack([f_m, f_0, f_p])
            max_index = jnp.argmax(factors3).astype(i32)
            new_order = (order + max_index - 1).astype(i32)
            factor = carry["safety"] * factors3[max_index]
            factor = jnp.minimum(factor, cfg.maximum_timestep_growth)
            factor = jnp.maximum(factor, cfg.minimum_timestep_shrink)
            do_change = (
                (factor >= cfg.minimum_timestep_growth)
                | (factor <= cfg.maximum_timestep_shrink)
                | (max_index != 1)
            )
            return new_order, factor.astype(dtype), do_change

        new_order, sel_factor, do_change = jax.lax.cond(
            n_equal > order,
            order_decide,
            lambda _: (
                order, jnp.asarray(1.0, dtype), jnp.asarray(False)
            ),
            None,
        )
        order_new = jnp.where(do_change, new_order, order).astype(i32)
        h_new = carry["h"] * jnp.where(do_change, sel_factor, 1.0)

        def apply_change(args):
            D, gD, sD = self._pack3_un(args)
            D2, gD2, sD2, _h = self._rescale_all(
                D, gD, sD, carry["h"], new_order, sel_factor
            )
            return self._pack3(D2, gD2, sD2)

        packed = jax.lax.cond(
            do_change,
            apply_change,
            lambda a: a,
            self._pack3(D_new, gD_new, sD_new),
        )
        D_new, gD_new, sD_new = self._pack3_un(packed)
        eta = jnp.where(do_change, ETA_RESET_TIMESTEP, eta)
        c2 = h_new * alpha[order_new]
        rel2 = jnp.abs(c2 / c_last - 1.0)
        rhs_pred2 = do_change & (ssrj >= opts.update_rhs_jacobian_after_steps)
        jac_pred2 = do_change & (
            (ssj >= opts.update_jacobian_after_steps)
            | (rel2 > opts.threshold_to_update_jacobian)
        )
        jac, factors, stats, eta, ssj, ssrj, c_last = self._jac_slim(
            jac, factors, stats, eta, ssj, ssrj, c_last,
            t_new, y_new, params, c2, rhs_pred2, jac_pred2,
            causes=(False, False, False, False, True),
        )
        n_equal_new = jnp.where(do_change, 0, n_equal).astype(i32)
        sel_status = jnp.where(
            do_change & (jnp.abs(h_new) < cfg.minimum_timestep),
            errors.STEP_SIZE_TOO_SMALL, errors.INTERNAL_TIMESTEP,
        ).astype(i32)

        new_state = state.replace(
            y=y_new, dy=dy_new, g=g_new, t=t_new, h=h_new,
            D=D_new, gD=gD_new, s=s_new, sD=sD_new,
            order=order_new, n_equal_steps=n_equal_new,
            prev_error_norm=err,
            newton_fails_total=carry["newton_fails"],
            state_modified=jnp.asarray(False),
            jac=jac, factors=factors, eta=eta, stats=stats,
            steps_since_jac=ssj, steps_since_rhs_jac=ssrj, c_last=c_last,
            root_g=root_g0,
        )

        # ---- root check (bdf.rs:1566-1579) ----
        stop = sel_status
        root_t = nan
        root_idx = jnp.asarray(-1, i32)
        if p.eqn.root is not None:
            res_root = check_root(
                lambda tt, yy: p.eqn.root(tt, yy, params),
                lambda tt: self.interpolate(new_state, tt),
                root_g0, state.t, y_new, t_new,
                nbatch=self._nb,
            )
            found = res_root.found & (stop == errors.INTERNAL_TIMESTEP)
            stop = jnp.where(found, errors.ROOT_FOUND, stop).astype(i32)
            stop = jnp.where(
                res_root.inconsistent, errors.ROOT_BATCH_INCONSISTENT, stop
            ).astype(i32)
            root_t = jnp.where(found, res_root.t_root, root_t)
            root_idx = jnp.where(found, res_root.root_idx, root_idx)
            new_state = new_state.replace(root_g=res_root.g0_next)

        # ---- tstop (bdf.rs:694-731), slim in-step form ----
        tr1 = 100.0 * eps * (jnp.abs(t_new) + jnp.abs(h_new))
        reached = have_tstop & (jnp.abs(t_new - tstop) <= tr1)
        overshoot = have_tstop & ~reached & jnp.where(
            h_new > 0.0,
            t_new + h_new > tstop + tr1,
            t_new + h_new < tstop - tr1,
        )
        ts_factor = jnp.where(overshoot, (tstop - t_new) / h_new, 1.0)

        def apply_ts(args):
            D, gD, sD = self._pack3_un(args)
            D2, gD2, sD2, _h = self._rescale_all(
                D, gD, sD, h_new, order_new, ts_factor
            )
            return self._pack3(D2, gD2, sD2)

        packed = jax.lax.cond(
            overshoot,
            apply_ts,
            lambda a: a,
            self._pack3(new_state.D, new_state.gD, new_state.sD),
        )
        D_ts, gD_ts, sD_ts = self._pack3_un(packed)
        new_state = new_state.replace(
            D=D_ts, gD=gD_ts, sD=sD_ts,
            h=h_new * ts_factor,
            n_equal_steps=jnp.where(overshoot, 0, new_state.n_equal_steps).astype(i32),
            eta=jnp.where(overshoot, ETA_RESET_TIMESTEP, new_state.eta),
        )
        stop = jnp.where(
            (stop == errors.INTERNAL_TIMESTEP) & reached,
            errors.TSTOP_REACHED, stop,
        ).astype(i32)
        new_state = new_state.replace(
            status=stop, root_t=root_t, root_idx=root_idx
        )

        # on fatal error keep the old state, record status
        final_status = jnp.where(failed, carry["status"], new_state.status).astype(
            i32
        )
        out = jax.tree_util.tree_map(
            lambda new, old: jnp.where(failed, old, new), new_state, state
        )
        return out.replace(status=final_status)

    # ------------------------------------------------------------------
    # cond-payload packing (sD is None unless sens; conds cannot carry None)
    def _pack5(self, D, gD, sD, y_pred, psi):
        return (D, gD, sD, y_pred, psi) if self.sens else (D, gD, y_pred, psi)

    def _unpack5(self, packed):
        if self.sens:
            return packed
        D, gD, y_pred, psi = packed
        return D, gD, None, y_pred, psi

    def _pack3(self, D, gD, sD):
        return (D, gD, sD) if self.sens else (D, gD)

    def _pack3_un(self, packed):
        if self.sens:
            return packed
        D, gD = packed
        return D, gD, None

    # ------------------------------------------------------------------
    def jacobian(self, state: BdfState, params=None):
        """df/dy at the current state (reference OdeSolverMethod::jacobian)."""
        params = self.problem.params if params is None else params
        return self.problem.eqn.jac(state.t, state.y, params)

    def mass(self, state: BdfState, params=None):
        """Mass matrix at the current state (None = identity)."""
        params = self.problem.params if params is None else params
        return self.problem.eqn.mass_matrix(state.t, params)

    # ------------------------------------------------------------------
    def interpolate(self, state: BdfState, t):
        return _interp_from_diff(t, state.D, state.t, state.h, state.order)

    def interpolate_dy(self, state: BdfState, t):
        return _interp_deriv_from_diff(t, state.D, state.t, state.h, state.order)

    def interpolate_out(self, state: BdfState, t):
        return _interp_from_diff(t, state.gD, state.t, state.h, state.order)

    def interpolate_sens(self, state: BdfState, t):
        return jax.vmap(
            lambda Dr: _interp_from_diff(t, Dr, state.t, state.h, state.order)
        )(state.sD)
