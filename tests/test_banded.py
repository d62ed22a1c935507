"""Banded linear-solver tier tests: LU correctness, coloring Jacobians,
heat1d/heat2d MOL problems on BDF (the KLU-replacement path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import diffsol_tpu as dt
from diffsol_tpu import errors
from diffsol_tpu.models import heat1d, heat2d
from diffsol_tpu.ops.banded import (
    band_to_dense,
    dense_to_band,
    make_banded_jac,
    make_banded_solver,
)


def test_banded_lu_random():
    rng = np.random.default_rng(7)
    for (n, ml, mu) in [(16, 2, 2), (25, 5, 5), (10, 1, 3)]:
        a = np.zeros((n, n))
        for i in range(n):
            for j in range(max(0, i - ml), min(n, i + mu + 1)):
                a[i, j] = rng.standard_normal()
            a[i, i] += 6.0
        spec = make_banded_solver(ml, mu)
        band = dense_to_band(jnp.asarray(a), ml, mu)
        x = spec.solve(spec.factor(band), jnp.asarray(rng.standard_normal(n)))
        b = jnp.asarray(a) @ x
        np.testing.assert_allclose(
            np.asarray(jnp.asarray(a) @ x), np.asarray(b), rtol=1e-12
        )


def test_banded_lu_batched():
    """Lockstep batching of factor+solve: batch-LAST (nb, n, B) band arrays
    and (n, B) right-hand sides (members on the lane axis)."""
    rng = np.random.default_rng(3)
    n, ml, mu, B = 12, 2, 2, 5
    a = rng.standard_normal((B, n, n)) * 0.1
    for b in range(B):
        a[b] += np.eye(n) * 4.0
        a[b] *= np.abs(np.arange(n)[None, :] - np.arange(n)[:, None]) <= 2
    spec = make_banded_solver(ml, mu)
    bands = jnp.moveaxis(
        jax.vmap(lambda m: dense_to_band(m, ml, mu))(jnp.asarray(a)), 0, -1
    )  # (nb, n, B)
    rhs = jnp.asarray(rng.standard_normal((B, n))).T  # (n, B)
    xs = spec.solve(spec.factor(bands), rhs)
    res = jnp.einsum("bij,jb->ib", jnp.asarray(a), xs) - rhs
    assert float(jnp.max(jnp.abs(res))) < 1e-10


def test_heat1d_banded_bdf():
    problem, soln = heat1d.make(mgrid=20)
    from diffsol_tpu.ops.banded import make_banded_solver
    import dataclasses

    problem = dataclasses.replace(
        problem, linear_solver=make_banded_solver(1, 1)
    )
    # install the banded jacobian
    from diffsol_tpu.ops.banded import make_banded_jac

    eqn = dataclasses.replace(
        problem.eqn, rhs_jac=make_banded_jac(problem.eqn.rhs, 1, 1)
    )
    problem = dataclasses.replace(problem, eqn=eqn)
    solver = dt.BdfSolver(problem)
    t_eval = jnp.asarray([0.5, 0.51, 0.52, 0.53, 0.54])
    sol = dt.solve_dense(solver, t_eval)
    assert int(sol.stop_reason) == errors.TSTOP_REACHED
    expected = soln(np.asarray(t_eval))
    np.testing.assert_allclose(np.asarray(sol.ys), expected, rtol=1e-3, atol=1e-4)


def test_heat2d_banded_bdf():
    """IDA idaHeat2D-class DAE on the banded tier (boundary constraints)."""
    mgrid = 10
    problem = heat2d.make(mgrid=mgrid)
    solver = dt.BdfSolver(problem)
    t_eval = jnp.asarray([0.01, 0.02, 0.04, 0.08, 0.16])
    sol = dt.solve_dense(solver, t_eval)
    assert int(sol.stop_reason) == errors.TSTOP_REACHED
    ys = np.asarray(sol.ys)
    # compare against a dense-tier solve of the same problem
    problem_dense = heat2d.make(mgrid=mgrid, banded=False)
    sol_d = dt.solve_dense(dt.BdfSolver(problem_dense), t_eval)
    np.testing.assert_allclose(ys, np.asarray(sol_d.ys), rtol=1e-4, atol=1e-7)
    # physics: heat decays, boundaries stay 0
    assert ys[-1].max() < ys[0].max()
    n = mgrid * mgrid
    idx = np.arange(n)
    boundary = ~(
        ((idx % mgrid) > 0)
        & ((idx % mgrid) < mgrid - 1)
        & ((idx // mgrid) > 0)
        & ((idx // mgrid) < mgrid - 1)
    )
    assert np.abs(ys[:, boundary]).max() < 1e-8


def _band_system(n, ml, mu, nbatch, dtype, seed):
    """Diagonally dominant band matrices (B, n, n), their batch-last band
    arrays (nb, n, B) and right-hand sides (B, n)."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    inside = (i[None, :] - i[:, None] <= mu) & (i[:, None] - i[None, :] <= ml)
    a = rng.standard_normal((nbatch, n, n)) * inside
    a[:, i, i] = np.abs(a).sum(-1) + 1.0
    band = np.stack([np.asarray(dense_to_band(m, ml, mu)) for m in a], -1)
    rhs = rng.standard_normal((nbatch, n))
    return a, jnp.asarray(band, dtype), rhs


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("layout", ["single", "batch_last", "augmented"])
@pytest.mark.parametrize("n,ml,mu", [(16, 1, 1), (40, 2, 3), (128, 5, 5),
                                     (400, 20, 20)])
@pytest.mark.parametrize("kernel", ["xla", "triton"])
def test_band_lu_vs_numpy(kernel, n, ml, mu, layout, dtype):
    """Both band LU kernels (the Triton one in interpret mode) against
    numpy.linalg.solve on the dense matrices, in the problem dtype: one
    system, a batch-last ensemble of B=8, and augmented rows (naug, n, B)
    sharing one factorization per member."""
    nbatch = 1 if layout == "single" else 8
    a, band, rhs = _band_system(n, ml, mu, nbatch, dtype, seed=n + ml)
    spec = make_banded_solver(ml, mu, kernel, interpret=True)
    if layout == "single":
        x = spec.solve(spec.factor(band[:, :, 0]), jnp.asarray(rhs[0], dtype))
        got = np.asarray(x)[None]
        ref = np.linalg.solve(a, rhs[..., None])[..., 0]
    elif layout == "batch_last":
        x = spec.solve(spec.factor(band), jnp.asarray(rhs.T, dtype))
        got = np.asarray(x).T
        ref = np.linalg.solve(a, rhs[..., None])[..., 0]
    else:
        aug = np.stack([rhs.T, -2.0 * rhs.T, 0.5 * rhs.T])  # (3, n, B)
        x = spec.solve(spec.factor(band), jnp.asarray(aug, dtype))
        got = np.asarray(x)
        ref = np.stack([np.linalg.solve(a, r.T[..., None])[..., 0].T
                        for r in aug])
    assert got.dtype == np.dtype(dtype)
    eps = float(jnp.finfo(dtype).eps)
    # diagonally dominant, no pivoting: backward-stable to ~(ml+mu+1) eps
    bound = 10.0 * (ml + mu + 1) * eps * np.max(np.abs(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=bound)


@pytest.mark.gpu
@pytest.mark.parametrize("n,ml,mu,nbatch", [(16, 1, 1, 5), (128, 1, 1, 1024),
                                            (400, 20, 20, 32)])
def test_triton_band_lu_on_card(gpu, n, ml, mu, nbatch):
    """The Triton kernels as compiled for the card against the XLA form:
    a batch-last ensemble, augmented rows, and one system."""
    _a, band, rhs = _band_system(n, ml, mu, nbatch, jnp.float64, seed=3)
    b = jnp.asarray(rhs.T)
    cases = [(band, b), (band, jnp.stack([b, -b])), (band[:, :, 0], b[:, 0])]
    tri = make_banded_solver(ml, mu, "triton")
    xla = make_banded_solver(ml, mu, "xla")
    for a_, b_ in cases:
        x_t = tri.solve(tri.factor(a_), b_)
        x_x = xla.solve(xla.factor(a_), b_)
        np.testing.assert_allclose(np.asarray(x_t), np.asarray(x_x), rtol=0,
                                   atol=1e-12 * float(jnp.max(jnp.abs(x_x))))


def test_pallas_band_kernels_match_xla():
    """The Triton factor/solve (interpret mode) agrees with the XLA form,
    including one-sided bands (ml=0 or mu=0), single and batch-last."""
    rng = np.random.default_rng(7)
    for ml, mu, n in [(1, 1, 12), (3, 2, 20), (0, 3, 9), (3, 0, 9), (4, 4, 33)]:
        a = np.eye(n) * 4.0 + rng.standard_normal((n, n)) * 0.2
        a *= (np.arange(n)[:, None] - np.arange(n)[None, :] <= ml)
        a *= (np.arange(n)[None, :] - np.arange(n)[:, None] <= mu)
        band = dense_to_band(jnp.asarray(a), ml, mu)
        b = jnp.asarray(rng.standard_normal(n))
        tri = make_banded_solver(ml, mu, "triton", interpret=True)
        xla = make_banded_solver(ml, mu, "xla")
        np.testing.assert_allclose(
            np.asarray(tri.solve(tri.factor(band), b)),
            np.asarray(xla.solve(xla.factor(band), b)), rtol=1e-13)
        B = 3
        bandB = band[:, :, None] * (1.0 + 0.1 * jnp.arange(B))
        bB = b[:, None] * jnp.ones((1, B))
        np.testing.assert_allclose(
            np.asarray(tri.solve(tri.factor(bandB), bB)),
            np.asarray(xla.solve(xla.factor(bandB), bB)), rtol=1e-13)


def test_pallas_banded_bdf_heat1d():
    """Full BDF solve through the Triton banded kernels (interpret mode on
    the CPU) matches the dense-tier solve of the same discretization."""
    from diffsol_tpu.models import heat1d
    from diffsol_tpu.solvers.bdf import BdfSolver
    from diffsol_tpu.drivers import solve_dense
    import dataclasses

    problem, _soln = heat1d.make(mgrid=15)
    spec = make_banded_solver(1, 1, kernel="triton", interpret=True)

    banded_problem = dataclasses.replace(
        problem,
        linear_solver=spec,
        eqn=dataclasses.replace(
            problem.eqn, rhs_jac=make_banded_jac(problem.eqn.rhs, 1, 1)
        ),
    )
    t_eval = jnp.asarray([0.01, 0.05, 0.1])
    sol = solve_dense(BdfSolver(banded_problem), t_eval, max_steps=2000)
    sol.raise_for_status()
    # same spatial discretization through the dense tier is the oracle
    ref = solve_dense(BdfSolver(problem), t_eval, max_steps=2000)
    err = np.max(np.abs(np.asarray(sol.ys) - np.asarray(ref.ys)))
    assert err < 1e-6, err


def _oscillator_chain():
    """An oscillator chain whose iteration matrix M - c*J has near-zero
    diagonals with +-1 off-diagonals: elimination without pivoting divides
    by ~0 immediately."""
    n = 16

    def rhs(t, y, p):
        u = y.reshape(n // 2, 2)
        du = jnp.stack([u[:, 1] * p[0], -u[:, 0] * p[0]], axis=1)
        return du.reshape(-1)

    return (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(lambda t, p: jnp.arange(1.0, n + 1.0))
        .p([1.0e8])  # stiff rotation: c*J dominates, zero diagonal
        .rtol(1e-8)
        .atol(1e-10)
        .linear_solver(make_banded_solver(1, 1, kernel="xla"))
        .build()
    )


def _zero_schur_pivot_dae():
    """A semi-explicit DAE chain of 3-row motifs
      y0' = y0;   0 = y0 - y2;   y2' = y1 - y2
    whose iteration matrix per motif [[1-c, 0, 0], [-c, 0, c], [0, -c, 1+c]]
    is nonsingular (a pivoting solver handles it) but has an EXACTLY zero
    pivot on every algebraic row without pivoting."""
    n = 12
    M0 = np.asarray(np.arange(n) % 3 == 0, np.float64)
    M1 = np.asarray(np.arange(n) % 3 == 1, np.float64)
    M2 = np.asarray(np.arange(n) % 3 == 2, np.float64)

    def rhs(t, y, p):
        left = jnp.concatenate([jnp.zeros_like(y[:1]), y[:-1]])
        right = jnp.concatenate([y[1:], jnp.zeros_like(y[:1])])
        return p[0] * (M0 * y + M1 * (left - right) + M2 * (left - y))

    return (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(lambda t, p: jnp.asarray(M0 + M2))  # consistent: y0 = y2
        .mass(lambda t, p: jnp.diag(jnp.asarray(1.0 - M1)))
        .p([1.0])
        .rtol(1e-6)
        .atol(1e-8)
        .linear_solver(make_banded_solver(1, 1))
        .build()
    )


def test_no_pivot_band_fails_loudly_not_silently():
    """The banded tier is a NO-PIVOT LU (valid for diagonally-dominant
    MOL operators).  A system that defeats it must surface as a TYPED
    solver failure (Newton non-convergence ladder), never as silently
    wrong numbers."""
    sol = dt.solve_dense(
        dt.BdfSolver(_oscillator_chain()), jnp.asarray([0.5, 1.0]),
        max_steps=200,
    )
    # loud: a typed failure code, and no finite-but-wrong trajectory
    assert int(sol.stop_reason) < 0


def test_no_pivot_band_fails_loudly_in_lockstep():
    """The same contract for a lockstep ensemble whose band LU meets an
    exactly zero pivot on every algebraic row."""
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, _zero_schur_pivot_dae(), [0.5, 1.0],
        jnp.ones((4, 1)), max_steps=200,
    )
    assert int(sol.stop_reason) < 0
