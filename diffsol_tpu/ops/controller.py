"""Adaptive step-size PI controller.

Mirrors the reference controller semantics
(reference crates/diffsol/src/ode_solver/runge_kutta.rs:1313-1335 `pi_controller_raw`
and :466-495 `factor`): the raw factor is

    err^(-kI/k) * prev_err^( kP/k) with combined exponent on err of -(kI+kP)/k

where ``err`` is the SQUARED scaled error norm, ``k = order + 1`` is the
effective order, and defaults kI = 0.5, kP = 0.0
(problem.rs:132-151).  All branching is traced (``jnp.where``) so the
controller runs inside jit-compiled solver loops.
"""

from __future__ import annotations

import jax.numpy as jnp


def pi_controller_raw(error_norm, prev_error_norm, pi_integral, pi_proportional, eff_order):
    """Raw PI-controller step-size factor.

    ``prev_error_norm`` may be NaN to indicate "no previous error" (the
    reference uses Option<T>): the proportional term is then dropped.
    ``error_norm`` and ``prev_error_norm`` are squared WRMS norms.
    """
    out_dtype = jnp.result_type(error_norm)
    # all controller transcendentals run in f32: the result is a step-size
    # factor clamped to ~[0.5, 2], far below f32 precision limits
    f32 = jnp.float32
    err32 = jnp.asarray(error_norm, f32)
    prev32 = jnp.asarray(prev_error_norm, f32)
    order_f = jnp.asarray(eff_order, f32)
    ki = jnp.asarray(pi_integral, f32) / order_f
    kp = jnp.asarray(pi_proportional, f32) / order_f
    have_prev = ~jnp.isnan(prev32)
    use_pi = (pi_proportional != 0.0) & have_prev
    tiny = jnp.asarray(1e-30, f32)
    huge = 1.0 / tiny
    err_safe = jnp.clip(err32, tiny, huge)
    prev_safe = jnp.clip(jnp.where(have_prev, prev32, 1.0), tiny, huge)
    i_only = err_safe**-ki
    pi_both = err_safe ** -(ki + kp) * prev_safe**kp
    return jnp.where(use_pi, pi_both, i_only).astype(out_dtype)


def clamp_factor(
    factor,
    min_reduce_factor,
    max_reduce_factor,
    min_increase_factor,
    max_increase_factor,
):
    """Dead-zone + hard clamps on the step-size factor (runge_kutta.rs:466-495).

    Inside the dead zone (max_reduce_factor, min_increase_factor) the factor is
    snapped to 1 (keep the step size); outside it is clamped to
    [min_reduce_factor, max_increase_factor].
    """
    factor = jnp.where(
        (factor > max_reduce_factor) & (factor < min_increase_factor), 1.0, factor
    )
    factor = jnp.maximum(factor, min_reduce_factor)
    factor = jnp.minimum(factor, max_increase_factor)
    return factor
