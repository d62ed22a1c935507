"""SDE solvers: Euler-Maruyama and Milstein.

The reference defines the stochastic operator interface and equation tier
(reference crates/diffsol/src/op/stoch.rs `StochOp` with noise kinds
Zero/Scalar/Diagonal/Additive classified by probing, ode_equations
`OdeEquationsStoch`) but ships NO stepper (ode_solver/sde.rs is a 7-line
marker trait).  This package completes the capability: fixed-step
Euler-Maruyama and (diagonal-noise) Milstein schemes over

    dy = f(t, y, p) dt + g(t, y, p) dW

with ``jax.random`` Brownian increments, fully jit/vmap-compatible --
``vmap`` over keys gives Monte Carlo path ensembles for free.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class SdeSolution(NamedTuple):
    ts: jax.Array  # (nsteps + 1,)
    ys: jax.Array  # (nsteps + 1, n)


def solve_em(
    rhs: Callable,
    diffusion: Callable,
    y0,
    t0,
    t1,
    nsteps: int,
    params,
    key,
) -> SdeSolution:
    """Euler-Maruyama with ``nsteps`` fixed steps on [t0, t1].

    ``diffusion(t, y, p)`` returns either (n,) for diagonal noise or
    (n, m) for m driving Wiener processes.
    """
    y0 = jnp.asarray(y0)
    dtype = y0.dtype
    t0 = jnp.asarray(t0, dtype)
    t1 = jnp.asarray(t1, dtype)
    h = (t1 - t0) / nsteps
    sqrt_h = jnp.sqrt(h)
    g_shape = jax.eval_shape(diffusion, t0, y0, params).shape
    m = g_shape[-1] if len(g_shape) > 1 else None

    def step(y, inp):
        t, key = inp
        gw_shape = y.shape if m is None else y.shape[:-1] + (m,)
        dw = jax.random.normal(key, gw_shape, dtype) * sqrt_h
        g = diffusion(t, y, params)
        noise = g * dw if m is None else g @ dw
        y_new = y + h * rhs(t, y, params) + noise
        return y_new, y_new

    keys = jax.random.split(key, nsteps)
    ts = t0 + h * jnp.arange(nsteps + 1, dtype=dtype)
    _, ys_tail = jax.lax.scan(step, y0, (ts[:-1], keys))
    ys = jnp.concatenate([y0[None], ys_tail], axis=0)
    return SdeSolution(ts=ts, ys=ys)


def solve_milstein(
    rhs: Callable,
    diffusion: Callable,
    y0,
    t0,
    t1,
    nsteps: int,
    params,
    key,
) -> SdeSolution:
    """Milstein scheme for DIAGONAL noise (strong order 1.0).

    y_{k+1} = y + h f + g dW + 1/2 g g' (dW^2 - h), with g' = d(diag g)/dy
    computed by JVP (the reference would need a hand-written derivative;
    here it is one forward-mode call).
    """
    y0 = jnp.asarray(y0)
    dtype = y0.dtype
    t0 = jnp.asarray(t0, dtype)
    t1 = jnp.asarray(t1, dtype)
    h = (t1 - t0) / nsteps
    sqrt_h = jnp.sqrt(h)

    def step(y, inp):
        t, key = inp
        dw = jax.random.normal(key, y.shape, dtype) * sqrt_h
        g = diffusion(t, y, params)
        # diagonal derivative dg_i/dy_i via one JVP in the direction g
        _, gg = jax.jvp(lambda yy: diffusion(t, yy, params), (y,), (g,))
        y_new = y + h * rhs(t, y, params) + g * dw + 0.5 * gg * (dw * dw - h)
        return y_new, y_new

    keys = jax.random.split(key, nsteps)
    ts = t0 + h * jnp.arange(nsteps + 1, dtype=dtype)
    _, ys_tail = jax.lax.scan(step, y0, (ts[:-1], keys))
    ys = jnp.concatenate([y0[None], ys_tail], axis=0)
    return SdeSolution(ts=ts, ys=ys)


def solve_em_ensemble(rhs, diffusion, y0, t0, t1, nsteps, params, key, npaths):
    """Monte Carlo path ensemble: vmap over per-path keys."""
    keys = jax.random.split(key, npaths)
    return jax.vmap(
        lambda k: solve_em(rhs, diffusion, y0, t0, t1, nsteps, params, k)
    )(keys)


def classify_noise(diffusion: Callable, y0, params, t=0.0) -> str:
    """Noise-kind classification (reference op/stoch.rs:6-66 `StochOpKind`
    Zero/Scalar/Diagonal/Additive/Other).

    The reference probes with NaN propagation through `process_inplace`;
    here the same structure is read off concrete Jacobians of the
    diffusion at randomized states (sound under the shared assumption that
    structure is state-independent).

    ``diffusion(t, y, p)`` returning (n,) is the diagonal storage form
    (one process per state); (n, m) is the general m-process form.
    """
    import numpy as np

    y0 = jnp.asarray(y0)
    n = int(y0.shape[-1])
    t = jnp.asarray(t, y0.dtype)
    g_shape = jax.eval_shape(diffusion, t, y0, params).shape
    diag_form = len(g_shape) == 1
    nprocess = n if diag_form else int(g_shape[-1])
    if nprocess == 0:
        return "zero"
    if nprocess == 1:
        return "scalar"

    rng = np.random.default_rng(0)
    dep = None  # dg/dy nonzero pattern, shape (n[, m], n)
    gpat = None  # g nonzero pattern
    for _ in range(2):
        y = jnp.asarray(
            np.asarray(y0) + rng.uniform(0.5, 1.5, size=(n,)), y0.dtype
        )
        jac = np.asarray(
            jax.jacfwd(lambda yy: diffusion(t, yy, params))(y)
        )
        g = np.asarray(diffusion(t, y, params))
        dep = (jac != 0.0) if dep is None else (dep | (jac != 0.0))
        gpat = (g != 0.0) if gpat is None else (gpat | (g != 0.0))

    if not dep.any():
        return "additive"
    if diag_form:
        # the diagonal storage form pairs process i with state i by
        # construction, which is exactly what the reference's per-process
        # d_w NaN probe checks (stoch.rs:43-63) -- state cross-coupling
        # inside g_i does NOT demote the kind there, so not here either
        # (note solve_milstein additionally assumes dg_i/dy_j = 0 for
        # j != i; that is a scheme precondition, not part of the kind)
        return "diagonal"
    # matrix form: diagonal means process k drives only state k (the
    # reference's probe sets d_w[k] = NaN and requires no other output to
    # turn NaN) -- i.e. no off-diagonal g entries
    if g_shape[-1] == n and not (gpat & ~np.eye(n, dtype=bool)).any():
        return "diagonal"
    return "other"
