"""Lockstep-ensemble scenarios, each against an independent reference.

Robertson ODE and DAE to t = 4e10 against the CVODE/IDA points, a root
stop, quadrature with and without output error control, a transcendental
rhs, a wide band and Dirichlet DAE rows (banded tier, against the matrix
exponential of the linear semi-discrete system).  Reset-continue and
heterogeneous heat1d members are cases of tests/test_ensemble.py; the
loud no-pivot failure is a case of tests/test_banded.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

import diffsol_tpu as dt
from diffsol_tpu import errors
from diffsol_tpu.models import robertson
from diffsol_tpu.ops.banded import make_banded_solver

T_EVAL_4E10 = [4.0 * 10.0**k for k in range(-1, 11)]


def _robertson_params(nbatch):
    k1 = 0.04 * (1.0 + 0.05 * np.linspace(-1.0, 1.0, nbatch))
    k1[nbatch // 2] = robertson.P_DEFAULT[0]
    return jnp.asarray(
        np.stack([k1, np.full(nbatch, 1.0e4), np.full(nbatch, 3.0e7)], 1))


@pytest.mark.parametrize("form", ["ode", "dae"])
def test_robertson_to_4e10_vs_cvode_points(form):
    """The default-parameter member of a lockstep ensemble follows the
    reference's CVODE/IDA table over 11 decades, within a few units of the
    solver tolerance (atol + rtol|y|; the table itself has 5 digits)."""
    make = robertson.problem_ode if form == "ode" else robertson.problem_dae
    problem = make(rtol=1e-4)
    nbatch = 5
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, T_EVAL_4E10, _robertson_params(nbatch),
        max_steps=5000,
    )
    assert int(sol.stop_reason) == errors.TSTOP_REACHED
    ys = np.asarray(sol.ys)  # (neval, B, 3)
    ref = robertson.SOLN[1:, 1:]
    tol = np.asarray([1e-8, 1e-6, 1e-6]) + 1e-4 * np.abs(ref)
    assert np.max(np.abs(ys[:, nbatch // 2] - ref) / tol) < 20.0
    np.testing.assert_allclose(ys.sum(-1), 1.0, atol=1e-9)


def test_lockstep_root_stop():
    """Stop at a shared root (threshold crossing of exponential decay):
    ROOT_FOUND at t = ln 2, the exact solution before it, zeros after."""
    problem = (
        dt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y)
        .init(lambda t, p: jnp.array([1.0]))
        .root(lambda t, y, p: y[0:1] - 0.5)
        .p([1.0])
        .rtol(1e-6)
        .atol(1e-8)
        .build()
    )
    t_eval = [0.25, 0.5, 1.0, 3.0]
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, jnp.ones((4, 1)), max_steps=4000
    )
    assert int(sol.stop_reason) == errors.ROOT_FOUND
    assert int(sol.root_idx) == 0
    np.testing.assert_allclose(float(sol.root_t), np.log(2.0), rtol=1e-5)
    ys = np.asarray(sol.ys)  # (neval, B, 1)
    np.testing.assert_allclose(
        ys[:2, :, 0], np.exp(-np.asarray(t_eval[:2]))[:, None] * np.ones(4),
        rtol=1e-5,
    )
    assert np.all(ys[2:] == 0.0)


@pytest.mark.parametrize("error_control", [False, True])
def test_lockstep_quadrature(error_control):
    """Quadrature of the output over heterogeneous members, with and
    without the output in the error test, against the closed form."""
    b = (
        dt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y)
        .init(lambda t, p: jnp.array([1.0]))
        .p([0.1])
        .rtol(1e-6)
        .atol(1e-8)
    )
    if error_control:
        b = (b.out(lambda t, y, p: jnp.array([y[0] * y[0]]))
             .integrate_out().out_rtol(1e-6).out_atol(1e-8))
    else:
        b = b.integrate_out()
    problem = b.build()
    assert problem.output_in_error_control() == error_control
    a = 0.5 * (1.0 + 0.2 * np.linspace(-1.0, 1.0, 4))
    t_eval = np.asarray([1.0, 4.0, 10.0])
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, jnp.asarray(a[:, None]),
        max_steps=4000,
    )
    assert int(sol.stop_reason) == errors.TSTOP_REACHED
    rate = 2.0 * a if error_control else a  # g = int y^2 or int y
    exact = (1.0 - np.exp(-rate[None, :] * t_eval[:, None])) / rate[None, :]
    np.testing.assert_allclose(np.asarray(sol.gs)[:, :, 0], exact, rtol=1e-5)


def test_lockstep_transcendental_rhs():
    """exp/sin/tanh/log1p in the rhs: the first state has the closed form
    y0(t) = -log(exp(-y0(0)) + p0 t) for every member."""

    def rhs(t, y, p):
        return jnp.stack([
            -p[0] * jnp.exp(y[0]),
            -p[1] * jnp.sin(y[1]) + p[0] * jnp.tanh(y[2]),
            -p[0] * y[2] * jnp.log1p(y[0] * y[0]),
        ])

    problem = (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(lambda t, p: jnp.array([0.5, 1.0, 0.8]))
        .p([1.0, 1.0])
        .rtol(1e-6)
        .atol(1e-9)
        .build()
    )
    a = np.linspace(0.5, 1.5, 4)
    t_eval = np.asarray([0.1, 0.5, 1.5])
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval,
        jnp.asarray(np.stack([a, np.ones(4)], 1)),
    )
    assert int(sol.stop_reason) == errors.TSTOP_REACHED
    exact = -np.log(np.exp(-0.5) + a[None, :] * t_eval[:, None])
    np.testing.assert_allclose(np.asarray(sol.ys)[:, :, 0], exact,
                               rtol=1e-5, atol=1e-7)


def _expm_reference(rhs, y0, d, t_eval, rows=slice(None)):
    """Exact solution of y' = d A y restricted to ``rows`` (A = drhs/dy)."""
    n = y0.shape[0]
    a = np.asarray(jax.jacfwd(rhs, argnums=1)(
        0.0, jnp.zeros(n), jnp.asarray([1.0])))[rows, rows]
    return np.stack([scipy.linalg.expm(d * t * a) @ y0[rows]
                     for t in t_eval])


def test_lockstep_wide_band():
    """ml = mu = 2 (4th-order 5-point stencil): multi-column update windows
    of the band LU and five-color Jacobian probes, per member against the
    matrix exponential."""
    n = 17
    h = 1.0 / (n + 1)

    def rhs(t, y, p):
        z2, z1 = jnp.zeros_like(y[:2]), jnp.zeros_like(y[:1])
        ym2 = jnp.concatenate([z2, y[:-2]])
        ym1 = jnp.concatenate([z1, y[:-1]])
        yp1 = jnp.concatenate([y[1:], z1])
        yp2 = jnp.concatenate([y[2:], z2])
        return p[0] * (-ym2 + 16.0 * ym1 - 30.0 * y + 16.0 * yp1 - yp2) / (
            12.0 * h * h)

    x = (np.arange(n) + 1.0) * h
    y0 = 4.0 * x * (1.0 - x)
    problem = (
        dt.OdeBuilder().rhs(rhs).init(lambda t, p: jnp.asarray(y0))
        .p([1.0]).rtol(1e-6).atol(1e-8)
        .linear_solver(make_banded_solver(2, 2)).build()
    )
    d = np.asarray([0.5, 1.0, 2.0])
    t_eval = [0.02, 0.1]
    sol = dt.solve_dense_ensemble(dt.BdfSolver, problem, t_eval,
                                  jnp.asarray(d[:, None]))
    assert int(sol.stop_reason) == errors.TSTOP_REACHED
    for m, dm in enumerate(d):
        np.testing.assert_allclose(
            np.asarray(sol.ys)[:, m], _expm_reference(rhs, y0, dm, t_eval),
            rtol=1e-4, atol=1e-6)


def test_lockstep_dirichlet_dae_rows():
    """Banded DAE whose boundary rows are algebraic (mass 0, u = 0): the
    rows stay pinned and the interior follows the exact solution of the
    interior ODE with zero boundary values."""
    n = 13
    h = 1.0 / (n - 1)

    def rhs(t, y, p):
        interior = p[0] * (y[:-2] - 2.0 * y[1:-1] + y[2:]) / (h * h)
        return jnp.concatenate([y[:1], interior, y[-1:]])

    x = np.arange(n) * h
    y0 = 4.0 * x * (1.0 - x)
    mass_diag = jnp.asarray(np.r_[0.0, np.ones(n - 2), 0.0])
    problem = (
        dt.OdeBuilder().rhs(rhs).init(lambda t, p: jnp.asarray(y0))
        .mass(lambda t, p: jnp.diag(mass_diag))
        .p([1.0]).rtol(1e-6).atol(1e-8)
        .linear_solver(make_banded_solver(1, 1)).build()
    )
    d = np.asarray([0.5, 2.0])
    t_eval = [0.02, 0.1]
    sol = dt.solve_dense_ensemble(dt.BdfSolver, problem, t_eval,
                                  jnp.asarray(d[:, None]))
    assert int(sol.stop_reason) == errors.TSTOP_REACHED
    ys = np.asarray(sol.ys)
    np.testing.assert_allclose(ys[:, :, [0, -1]], 0.0, atol=1e-9)
    for m, dm in enumerate(d):
        np.testing.assert_allclose(
            ys[:, m, 1:-1],
            _expm_reference(rhs, y0, dm, t_eval, rows=slice(1, -1)),
            rtol=1e-4, atol=1e-6)
