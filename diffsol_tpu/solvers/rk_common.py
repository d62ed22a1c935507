"""Shared Runge-Kutta machinery (state, interpolation, tstop, stats).

Re-design of the reference shared RK core
(reference crates/diffsol/src/ode_solver/runge_kutta.rs:32-1421 `Rk` and
sdirk_state.rs `RkState`): solver state is a pytree carried through one
jitted ``lax.while_loop`` per solve; stage arrays have static shape
``(s, nstates)`` holding the stage values ``z_i = h * f(stage_i)``.

Interpolation inside the last accepted step [t_prev, t] uses the tableau's
continuous-extension beta polynomial when available, else a cubic Hermite
built from the first/last stage values (runge_kutta.rs:962-1079).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass
from .. import errors
from .tableau import Tableau


class Stats(NamedTuple):
    """Solver statistics (reference `OdeSolverStatistics`,
    ode_solver/mod.rs:28-77), carried as traced counters.

    The five ``lu_from_*`` counters are the reference's per-cause LU-setup
    breakdown (`record_linear_solver_setup`, ode_solver/mod.rs:53-70); they
    sum to ``linear_solver_setups``."""

    steps: jax.Array
    error_test_failures: jax.Array
    newton_iterations: jax.Array
    newton_fails: jax.Array
    linear_solver_setups: jax.Array
    jacobian_evals: jax.Array
    lu_from_checkpoint: jax.Array
    lu_from_first_fail: jax.Array
    lu_from_second_fail: jax.Array
    lu_from_error_test: jax.Array
    lu_from_step_success: jax.Array
    # lockstep diagnostic (extension beyond the reference counters): the
    # member whose WRMS term dominated the most recent error test -- names
    # the culprit under shared-fate failure semantics (norms.worst_member)
    # (plain-int default: a module-level jnp constant would initialize the
    # backend at import, breaking later platform overrides)
    worst_member: jax.Array = 0
    # op-call counters (reference `OpStatistics`, op/mod.rs: number_of_calls
    # / number_of_jac_muls / number_of_matrix_evals).  rhs_evals counts
    # residual rhs evaluations in the step loop (one per Newton iteration,
    # one per ERK stage); jac_mul_evals the JVP probes behind each Jacobian
    # evaluation (n dense, ncolors colored, ml+mu+1 banded); mass_evals the
    # mass-matrix materializations at LU assembly.
    rhs_evals: jax.Array = 0
    jac_mul_evals: jax.Array = 0
    mass_evals: jax.Array = 0

    @staticmethod
    def zeros() -> "Stats":
        z = jnp.asarray(0, jnp.int32)
        return Stats(z, z, z, z, z, z, z, z, z, z, z, z, z, z, z)


@pytree_dataclass
class RkState:
    """Carried state for ERK/SDIRK steppers.

    ``y/dy/g/t/h`` mirror the reference `StateCommon` (state.rs:21-43);
    ``*_prev`` is the pre-step state used for dense output; ``diff``/``gdiff``
    are the accepted step's stage values.  ``tstop`` is NaN when unset;
    ``prev_error_norm`` is NaN for "no previous error".  SDIRK additionally
    carries the Jacobian, its factorization, the Newton eta memory and the
    Jacobian-update policy counters.  Sensitivity fields (s, ds, sdiff) are
    ``None`` unless sensitivities are enabled.
    """

    y: jax.Array
    dy: jax.Array
    g: jax.Array
    t: jax.Array
    h: jax.Array
    y_prev: jax.Array
    dy_prev: jax.Array
    g_prev: jax.Array
    t_prev: jax.Array
    diff: jax.Array  # (s, n) stage values z_i = h * k_i
    gdiff: jax.Array  # (s, nout)
    prev_error_norm: jax.Array
    root_g: jax.Array  # (nroots,)
    tstop: jax.Array
    status: jax.Array  # int32 stop reason / error code of last step
    root_t: jax.Array
    root_idx: jax.Array
    state_modified: jax.Array  # bool
    stats: Stats
    # SDIRK-only (None for ERK)
    jac: Optional[jax.Array] = None
    factors: Optional[tuple] = None
    eta: Optional[jax.Array] = None
    steps_since_jac: Optional[jax.Array] = None
    steps_since_rhs_jac: Optional[jax.Array] = None
    h_at_last_jac: Optional[jax.Array] = None
    # augmented rows / sensitivities (None unless enabled)
    s: Optional[jax.Array] = None  # (naug, n)
    ds: Optional[jax.Array] = None  # (naug, n)
    sdiff: Optional[jax.Array] = None  # (naug, s, n)
    s_prev: Optional[jax.Array] = None  # (naug, n), pre-step (dense output)


def tableau_arrays(tab: Tableau, dtype):
    a = jnp.asarray(np.asarray(tab.a), dtype)
    b = jnp.asarray(np.asarray(tab.b), dtype)
    c = jnp.asarray(np.asarray(tab.c), dtype)
    d = jnp.asarray(np.asarray(tab.d), dtype)
    beta = None if tab.beta is None else jnp.asarray(np.asarray(tab.beta), dtype)
    return a, b, c, d, beta


# --------------------------------------------------------------------------
# dense output
# --------------------------------------------------------------------------


def lincomb(coeffs, rows):
    """``sum_j coeffs[j] * rows[j]`` for static tableau coefficients, as
    unrolled scalar multiply-adds: one fused elementwise kernel instead of a
    matrix product with a small constant vector (which XLA's GPU compiler
    mis-slices when the rows are sharded across devices)."""
    terms = [float(c) * rows[j] for j, c in enumerate(coeffs) if c != 0.0]
    if not terms:
        return jnp.zeros_like(rows[0])
    out = terms[0]
    for term in terms[1:]:
        out = out + term
    return out


def _beta_poly(tab: Tableau, theta, dtype, deriv: bool):
    beta = jnp.asarray(np.asarray(tab.beta), dtype)
    p = beta.shape[1]
    k = jnp.arange(1, p + 1, dtype=dtype)
    if deriv:
        powers = k * theta ** (k - 1.0)  # d/dtheta theta^k
    else:
        powers = theta**k
    return beta @ powers  # (s,)


def interp_y(tab: Tableau, state: RkState, t):
    """Interpolate y inside [t_prev, t] (runge_kutta.rs:1083-1127)."""
    dtype = state.y.dtype
    dt = state.t - state.t_prev
    theta = jnp.where(dt == 0.0, 1.0, (t - state.t_prev) / dt)
    if tab.beta is not None:
        bf = _beta_poly(tab, theta, dtype, deriv=False)
        return state.y_prev + state.diff.T @ bf
    return _hermite(theta, state.y_prev, state.y, state.diff)


def interp_dy(tab: Tableau, state: RkState, t):
    dtype = state.y.dtype
    dt = state.t - state.t_prev
    theta = jnp.where(dt == 0.0, 1.0, (t - state.t_prev) / dt)
    safe_dt = jnp.where(dt == 0.0, 1.0, dt)
    if tab.beta is not None:
        dbf = _beta_poly(tab, theta, dtype, deriv=True)
        val = (state.diff.T @ dbf) / safe_dt
    else:
        val = _hermite_deriv(theta, safe_dt, state.y_prev, state.y, state.diff)
    return jnp.where(dt == 0.0, state.dy, val)


def interp_out(tab: Tableau, state: RkState, t):
    dtype = state.y.dtype
    dt = state.t - state.t_prev
    theta = jnp.where(dt == 0.0, 1.0, (t - state.t_prev) / dt)
    if tab.beta is not None:
        bf = _beta_poly(tab, theta, dtype, deriv=False)
        return state.g_prev + state.gdiff.T @ bf
    return _hermite(theta, state.g_prev, state.g, state.gdiff)


def interp_sens(tab: Tableau, state: RkState, t):
    """Interpolate the augmented rows inside [t_prev, t] (per-row analog of
    :func:`interp_y`; reference interpolate_sens, runge_kutta.rs:1083+)."""
    dtype = state.y.dtype
    dt = state.t - state.t_prev
    theta = jnp.where(dt == 0.0, 1.0, (t - state.t_prev) / dt)
    if tab.beta is not None:
        bf = _beta_poly(tab, theta, dtype, deriv=False)
        return state.s_prev + jnp.tensordot(state.sdiff, bf, axes=[[1], [0]])
    return jax.vmap(lambda u0, u1, df: _hermite(theta, u0, u1, df))(
        state.s_prev, state.s, state.sdiff
    )


def _hermite(theta, u0, u1, diff):
    f0 = diff[0]
    f1 = diff[-1]
    q = (1.0 - 2.0 * theta) * (u1 - u0) + (theta - 1.0) * f0 + theta * f1
    return theta * (theta - 1.0) * q + (1.0 - theta) * u0 + theta * u1


def _hermite_deriv(theta, dt, u0, u1, diff):
    f0 = diff[0]
    f1 = diff[-1]
    q = (1.0 - 2.0 * theta) * (u1 - u0) + (theta - 1.0) * f0 + theta * f1
    dq = -2.0 * (u1 - u0) + f0 + f1
    return ((u1 - u0) + (2.0 * theta - 1.0) * q + theta * (theta - 1.0) * dq) / dt


# --------------------------------------------------------------------------
# tstop
# --------------------------------------------------------------------------


def tstop_check(t, h, tstop, dtype):
    """Post-step tstop handling (runge_kutta.rs:752-783).

    Returns (reached: bool, h_new): ``reached`` when t is within roundoff of
    tstop; otherwise h is scaled to land exactly on tstop if the next step
    would overshoot.  ``tstop`` NaN means no stop time (returns h unchanged).
    """
    eps = jnp.finfo(dtype).eps
    have = ~jnp.isnan(tstop)
    troundoff = 100.0 * eps * (jnp.abs(t) + jnp.abs(h))
    reached = have & (jnp.abs(t - tstop) <= troundoff)
    fwd = h > 0.0
    overshoot = jnp.where(
        fwd, t + h > tstop + troundoff, t + h < tstop - troundoff
    )
    factor = jnp.where(have & overshoot & ~reached, (tstop - t) / h, 1.0)
    return reached, h * factor
