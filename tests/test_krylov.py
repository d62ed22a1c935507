"""Matrix-free Newton-Krylov linear tier (GMRES + tridiagonal Thomas
preconditioner) -- the third KLU-role tier, for patterns that are neither
banded nor block-decomposable; used when requested explicitly)."""

import jax
import jax.numpy as jnp
import numpy as np

import diffsol_tpu as dt


def test_tridiag_thomas_roundtrip():
    from diffsol_tpu.ops.krylov import _thomas_factor, _thomas_solve

    rng = np.random.default_rng(0)
    n = 40
    d = jnp.asarray(rng.uniform(2.0, 3.0, n))
    a = jnp.asarray(np.concatenate([[0.0], rng.uniform(-0.5, 0.5, n - 1)]))
    c = jnp.asarray(np.concatenate([rng.uniform(-0.5, 0.5, n - 1), [0.0]]))
    A = np.diag(np.asarray(d)) + np.diag(np.asarray(a)[1:], -1) + np.diag(
        np.asarray(c)[:-1], 1
    )
    b = jnp.asarray(rng.standard_normal(n))
    x = _thomas_solve(_thomas_factor(a, d, c), b)
    np.testing.assert_allclose(A @ np.asarray(x), np.asarray(b), rtol=1e-10)


def test_krylov_heat1d_matches_dense():
    """Stiff MOL diffusion through the krylov tier matches the dense-LU
    solve (same problem, explicit .linear_solver('krylov'))."""
    from diffsol_tpu.models import heat1d

    ref_problem, _ = heat1d.make(mgrid=31)  # n = 32
    t_eval = jnp.asarray([0.05, 0.1])

    kry = (
        dt.OdeBuilder()
        .rhs(ref_problem.eqn.rhs)
        .init(ref_problem.eqn.init)
        .p(np.asarray(ref_problem.params))
        .rtol(1e-6)
        .atol(1e-8)
        .linear_solver("krylov")
        .build()
    )
    assert kry.linear_solver.name == "krylov(lu32)"
    sol_k = dt.solve_dense(dt.BdfSolver(kry), t_eval, max_steps=2000)
    assert int(sol_k.stop_reason) >= 0
    sol_d = dt.solve_dense(dt.BdfSolver(ref_problem), t_eval, max_steps=2000)
    np.testing.assert_allclose(
        np.asarray(sol_k.ys), np.asarray(sol_d.ys), rtol=1e-4, atol=1e-8
    )


def test_krylov_handles_nondiagonal_coupling():
    """A problem whose Jacobian has off-tridiagonal structure (global
    coupling): the tridiagonal preconditioner only approximates, GMRES
    still converges to the right solve."""

    n = 24
    rng = np.random.default_rng(1)
    # diffusion + a weak dense global coupling term
    C = jnp.asarray(rng.uniform(-0.02, 0.02, (n, n)))

    def rhs(t, y, p):
        lap = jnp.roll(y, 1) - 2.0 * y + jnp.roll(y, -1)
        return p[0] * lap * (n * n) + C @ y

    def init(t, p):
        x = jnp.linspace(0.0, 1.0, n)
        return jnp.sin(2.0 * jnp.pi * x) + 0.5

    def build(ls):
        b = (
            dt.OdeBuilder().rhs(rhs).init(init).p([0.05])
            .rtol(1e-7).atol(1e-9)
        )
        if ls:
            b = b.linear_solver("krylov")
        return b.build()

    t_eval = jnp.asarray([0.02, 0.05])
    sol_k = dt.solve_dense(dt.BdfSolver(build(True)), t_eval, max_steps=2000)
    sol_d = dt.solve_dense(dt.BdfSolver(build(False)), t_eval, max_steps=2000)
    assert int(sol_k.stop_reason) >= 0
    np.testing.assert_allclose(
        np.asarray(sol_k.ys), np.asarray(sol_d.ys), rtol=1e-5, atol=1e-9
    )


def test_auto_route_large_unstructured_to_krylov():
    """use_coloring on a large pattern that is neither banded nor block
    structured keeps the colored dense tier on every backend (a pivoted
    dense LU beats GMRES at this size); the matrix-free krylov route is
    exercised by requesting it explicitly, against the same expm
    reference."""
    n = 300
    rng = np.random.default_rng(2)
    C = jnp.asarray(rng.uniform(-0.01, 0.01, (n, n)))  # dense coupling

    problem = (
        dt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y + C @ y)
        .init(lambda t, p: jnp.ones((n,)))
        .p([1.0])
        .rtol(1e-6)
        .atol(1e-8)
        .use_coloring()
        .build()
    )
    assert problem.linear_solver.name.startswith("dense"), (
        problem.linear_solver.name
    )
    # the matrix-free route: same problem, krylov requested explicitly
    problem = (
        dt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y + C @ y)
        .init(lambda t, p: jnp.ones((n,)))
        .p([1.0])
        .rtol(1e-6)
        .atol(1e-8)
        .linear_solver("krylov")
        .build()
    )
    assert problem.linear_solver.name.startswith("krylov")
    sol = dt.solve_dense(
        dt.BdfSolver(problem), jnp.asarray([0.5, 1.0]), max_steps=2000
    )
    assert int(sol.stop_reason) >= 0
    # reference: linear constant-coefficient system, expm solution
    import scipy.linalg

    A = np.asarray(C) - np.eye(n)
    y1 = scipy.linalg.expm(A * 1.0) @ np.ones(n)
    np.testing.assert_allclose(
        np.asarray(sol.ys[1]), y1, rtol=1e-4, atol=1e-7
    )


def test_krylov_dae_diag_mass_heat2d():
    """Singular-diagonal-mass DAE through the krylov tier: the DiagMass
    operator branch and the matrix-free consistent-IC solve both engage;
    trajectories match the banded-tier solve."""
    from diffsol_tpu.models import heat2d

    ref = heat2d.make(mgrid=10)  # n = 100, banded tier
    kry = (
        dt.OdeBuilder()
        .rhs(ref.eqn.rhs)
        .init(ref.eqn.init)
        .mass(ref.eqn.mass)
        .p(np.asarray(ref.params))
        .rtol(1e-5)
        .atol(1e-5)
        .linear_solver("krylov")
        .build()
    )
    assert kry.linear_solver.name == "krylov(lu32)"
    assert kry.eqn.mass_diag_fn is not None
    t_eval = jnp.asarray([0.01, 0.1])
    sol_k = dt.solve_dense(dt.BdfSolver(kry), t_eval, max_steps=2000)
    assert int(sol_k.stop_reason) >= 0
    sol_b = dt.solve_dense(dt.BdfSolver(ref), t_eval, max_steps=2000)
    np.testing.assert_allclose(
        np.asarray(sol_k.ys), np.asarray(sol_b.ys), rtol=1e-3, atol=1e-6
    )


def test_krylov_forward_sensitivities():
    """Continuous forward sens on a krylov problem: the augmented rows
    (naug, n) go through the matrix-free solve's vmap branch."""
    from diffsol_tpu.models import heat1d
    from diffsol_tpu.sens import solve_dense_fwd_sens

    ref_problem, _ = heat1d.make(mgrid=15)  # n = 16
    kry = (
        dt.OdeBuilder()
        .rhs(ref_problem.eqn.rhs)
        .init(ref_problem.eqn.init)
        .p(np.asarray(ref_problem.params))
        .rtol(1e-7)
        .atol(1e-9)
        .linear_solver("krylov")
        .build()
    )
    t_eval = jnp.asarray([0.05, 0.1])
    ys, sens = solve_dense_fwd_sens(dt.BdfSolver(kry, sens=True), t_eval)
    # oracle: jacfwd through the dense-LU solver
    from diffsol_tpu.drivers import solve_dense

    solver_d = dt.BdfSolver(ref_problem)

    def ys_plain(p):
        return solve_dense(solver_d, t_eval, params=p, max_steps=2000).ys

    jac = jax.jacfwd(ys_plain)(ref_problem.params)  # (neval, n, np)
    np.testing.assert_allclose(
        np.asarray(sens[0]), np.asarray(jac[:, :, 0]), rtol=2e-3, atol=1e-7
    )


def test_krylov_lockstep_ensemble_matches_independent():
    """Lockstep (n, B) lift of the krylov tier (reference role: per-batch
    factorization under the nbatch context, cuda/lu.rs:69-96): a stiff
    MOL diffusion ensemble with spread diffusivities solves through
    batched GMRES + per-member f32-LU preconditioning and matches
    per-member single-instance solves."""
    from diffsol_tpu.ensemble import make_lockstep_problem
    from diffsol_tpu.models import heat1d

    ref_problem, _ = heat1d.make(mgrid=31)  # n = 32
    kry = (
        dt.OdeBuilder()
        .rhs(ref_problem.eqn.rhs)
        .init(ref_problem.eqn.init)
        .p(np.asarray(ref_problem.params))
        .rtol(1e-6)
        .atol(1e-8)
        .linear_solver("krylov")
        .build()
    )
    nb = 4
    lp = make_lockstep_problem(kry, nb)
    assert lp.linear_solver.name == "krylov_lockstep(lu32)"
    diffusivities = np.linspace(0.8, 1.2, nb)
    params_b = jnp.asarray(diffusivities)[:, None]
    t_eval = jnp.asarray([0.05, 0.1])
    sol = dt.solve_dense(
        dt.BdfSolver(lp), t_eval, params=params_b, max_steps=2000
    )
    assert int(sol.stop_reason) >= 0
    ys = np.asarray(sol.ys)  # (neval, n, B)
    for i, d in enumerate(diffusivities):
        sol_1 = dt.solve_dense(
            dt.BdfSolver(kry), t_eval, params=jnp.asarray([d]),
            max_steps=2000,
        )
        np.testing.assert_allclose(
            ys[:, :, i], np.asarray(sol_1.ys), rtol=1e-4, atol=1e-7
        )


def test_krylov_lockstep_dae_consistent_ic():
    """Krylov lockstep over a singular-diagonal-mass DAE: the batched
    matrix-free consistent-IC solve (per-member probe preconditioner)
    engages and the trajectory matches the banded-tier lockstep solve."""
    from diffsol_tpu.ensemble import make_lockstep_problem
    from diffsol_tpu.models import heat2d

    ref = heat2d.make(mgrid=8)  # n = 64, banded tier, diag mass
    kry = (
        dt.OdeBuilder()
        .rhs(ref.eqn.rhs)
        .init(ref.eqn.init)
        .mass(ref.eqn.mass)
        .p(np.asarray(ref.params))
        .rtol(1e-5)
        .atol(1e-5)
        .linear_solver("krylov")
        .build()
    )
    nb = 3
    lp_k = make_lockstep_problem(kry, nb)
    lp_b = make_lockstep_problem(ref, nb)
    params_b = jnp.broadcast_to(kry.params, (nb,) + kry.params.shape)
    t_eval = jnp.asarray([0.01, 0.1])
    sol_k = dt.solve_dense(
        dt.BdfSolver(lp_k), t_eval, params=params_b, max_steps=2000
    )
    assert int(sol_k.stop_reason) >= 0
    sol_b = dt.solve_dense(
        dt.BdfSolver(lp_b), t_eval,
        params=jnp.broadcast_to(ref.params, (nb,) + ref.params.shape),
        max_steps=2000,
    )
    np.testing.assert_allclose(
        np.asarray(sol_k.ys), np.asarray(sol_b.ys), rtol=1e-3, atol=1e-6
    )
