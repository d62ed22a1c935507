"""Newton iteration with Sundials-style rate-based convergence control.

Reimplements the semantics of the reference nonlinear solver
(reference crates/diffsol-nl/src/newton.rs:13-36 `newton_iteration`,
convergence.rs `Convergence::check_new_iteration`, line_search.rs:44-72
`NoLineSearch`) as a jit-compatible ``lax.while_loop``:

* each iteration solves ``J delta = F(x)`` with a FROZEN factorization and
  takes the full step ``x <- x - delta``;
* the convergence measure is the WRMS norm of ``delta`` scaled by the
  predicted state ``error_y``;
* from the 2nd iteration the mean rate ``r = (||d_k||/||d_1||)^(1/(k-1))``
  is tracked: the iteration DIVERGES if ``r > 0.9`` or if the projected
  terminal residual ``r^(max_iter-k)/(1-r) * ||d_k||`` exceeds ``tol``;
* it CONVERGES when ``eta * ||d_k|| < tol`` with ``eta = r/(1-r)`` (first
  iteration: ``eta = max(eta_prev, 1e4*eps)^0.8``, carried across solves,
  reset to 20^1.25 on Jacobian refresh and 100^1.25 on step-size change,
  convergence.rs:36-42).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..norms import norm as wrms_norm

CONTINUE = 0
CONVERGED = 1
DIVERGED = 2

ETA_RESET_JACOBIAN = 20.0**1.25
ETA_RESET_TIMESTEP = 100.0**1.25


class NewtonResult(NamedTuple):
    x: jax.Array
    converged: jax.Array  # bool
    niter: jax.Array  # int32, iterations taken
    eta: jax.Array  # final eta, persisted by the caller


def newton_solve(
    residual: Callable,
    lin_solve: Callable,
    x0,
    error_y,
    atol,
    rtol,
    eta0,
    *,
    tol: float = 0.2,
    max_iter: int = 10,
    nbatch: int = 1,
) -> NewtonResult:
    """Solve ``residual(x) = 0`` by damped-free Newton with frozen Jacobian.

    ``lin_solve(v)`` applies the (already factorized) iteration matrix
    inverse.  ``eta0`` is the convergence-rate memory carried across solves.
    """
    dtype = jnp.result_type(x0)
    eps = jnp.finfo(dtype).eps
    tol_ = jnp.asarray(tol, dtype)

    def cond(carry):
        _, _, _, niter, status = carry
        return (status == CONTINUE) & (niter < max_iter)

    def body(carry):
        x, first_norm, eta, niter, _ = carry
        delta = lin_solve(residual(x))
        x = x - delta
        nrm = wrms_norm(delta, error_y, atol, rtol, nbatch)
        niter = niter + 1

        # convergence-rate bookkeeping in f32: only feeds accept/diverge
        # decisions and the eta heuristic
        f32 = jnp.float32
        nrm32 = jnp.asarray(nrm, f32)
        # first iteration: eta = max(eta_prev, 1e4*eps)^0.8
        eta_first = jnp.maximum(jnp.asarray(eta, f32), 1e4 * eps) ** jnp.asarray(
            0.8, f32
        )

        # subsequent iterations: rate-based checks against the first norm
        k = jnp.maximum(niter - 1, 1).astype(f32)
        rate = (
            nrm32 / jnp.maximum(jnp.asarray(first_norm, f32), jnp.asarray(0.0, f32))
        ) ** (1.0 / k)
        rate = jnp.where(jnp.isfinite(rate), rate, jnp.asarray(jnp.inf, f32))
        diverged_rate = rate > 0.9
        proj = (
            rate ** jnp.maximum(max_iter - niter, 0).astype(f32)
            / (1.0 - rate)
            * nrm32
        )
        diverged_proj = proj > jnp.asarray(tol_, f32)
        eta_later = rate / (1.0 - rate)

        is_first = niter == 1
        eta_new = jnp.where(is_first, eta_first, eta_later).astype(dtype)
        diverged = (~is_first) & (diverged_rate | diverged_proj)
        converged = (eta_new * nrm < tol_) & ~diverged

        status = jnp.where(
            diverged, DIVERGED, jnp.where(converged, CONVERGED, CONTINUE)
        ).astype(jnp.int32)
        first_norm = jnp.where(is_first, nrm, first_norm)
        return (x, first_norm, eta_new, niter, status)

    init = (
        x0,
        jnp.asarray(0.0, dtype),
        jnp.asarray(eta0, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(CONTINUE, jnp.int32),
    )
    x, _, eta, niter, status = jax.lax.while_loop(cond, body, init)
    return NewtonResult(x=x, converged=status == CONVERGED, niter=niter, eta=eta)
