"""Block-diagonal sparse tier (coloring -> dense-block compression).

The KLU-role path for unstructured-but-decomposable patterns (reference
suitesparse/klu.rs; benchmarked on robertson_ode's ngroups block layout,
book sundials.md).  The builder detects connected components and solves
them as batch-last (nb, nb, K) dense blocks -- no dense (n, n) Jacobian is
ever materialized in the solve path.
"""

import jax
import jax.numpy as jnp
import numpy as np

import diffsol_tpu as dt
from diffsol_tpu.models import robertson


def test_builder_routes_block_diagonal_pattern():
    problem = robertson.problem_ode_groups(50)
    assert problem.linear_solver.name == "blockdiag(3,50)"
    # Jacobian representation is the block stack, not a dense (150, 150)
    y0 = problem.eqn.init(problem.t0, problem.params)
    jac = problem.eqn.jac(problem.t0, y0, problem.params)
    assert jac.shape == (3, 3, 50)


def test_blockdiag_jac_matches_jacfwd():
    problem = robertson.problem_ode_groups(7)
    y = jnp.asarray(
        np.random.default_rng(1).uniform(0.1, 1.0, size=(21,))
    )
    blocks = problem.eqn.jac(0.0, y, problem.params)  # (3, 3, 7)
    dense = jax.jacfwd(
        lambda yy: problem.eqn.rhs(0.0, yy, problem.params)
    )(y)
    for k in range(7):
        np.testing.assert_allclose(
            np.asarray(blocks[:, :, k]),
            np.asarray(dense[3 * k : 3 * k + 3, 3 * k : 3 * k + 3]),
            rtol=1e-12,
        )
    # off-diagonal blocks really are zero (the compression is lossless)
    dense_np = np.array(dense)
    for k in range(7):
        dense_np[3 * k : 3 * k + 3, 3 * k : 3 * k + 3] = 0.0
    assert np.all(dense_np == 0.0)


def test_blockdiag_solve_matches_reference_table():
    """ngroups=50 robertson_ode through the block tier reproduces the
    CVODE reference values in every group (robertson_ode.rs soln)."""
    problem = robertson.problem_ode_groups(50)
    t_eval = jnp.asarray([0.4, 4.0, 40.0])
    sol = dt.solve_dense(dt.BdfSolver(problem), t_eval, max_steps=2000)
    assert int(sol.stop_reason) >= 0
    ys = np.asarray(sol.ys).reshape(3, 50, 3)
    data = robertson.SOLN
    for row in range(3):
        np.testing.assert_allclose(
            ys[row, :, 0], data[row + 1, 1], rtol=5e-3
        )
        # all groups identical
        assert np.ptp(ys[row, :, 0]) < 1e-10


def test_blockdiag_uneven_components_padded():
    """Components of different sizes (2 and 3) are padded to one block
    size; the solve matches the dense-LU reference trajectory."""

    def rhs(t, y, p):
        # component A: states 0,1 (coupled oscillator-ish decay)
        # component B: states 2,3,4 (chain)
        a = jnp.array([-y[0] + 0.5 * y[1], -0.8 * y[1] + 0.1 * y[0]])
        b = jnp.array(
            [
                -2.0 * y[2] + y[3],
                -1.5 * y[3] + 0.2 * y[4],
                -0.7 * y[4] + 0.3 * y[2],
            ]
        )
        return jnp.concatenate([a, b]) * p[0]

    def init(t, p):
        return jnp.array([1.0, 2.0, 3.0, 4.0, 5.0])

    def build(coloring):
        b = (
            dt.OdeBuilder().rhs(rhs).init(init).p([1.0])
            .rtol(1e-8).atol(1e-10)
        )
        if coloring:
            b = b.use_coloring()
        return b.build()

    # 5 states < 8: the auto-router keeps dense; call the tier directly
    from diffsol_tpu.ops.blockdiag import (
        detect_blocks,
        make_blockdiag_jac,
        make_blockdiag_solver,
    )
    from diffsol_tpu.ops.coloring import detect_sparsity

    pb = build(False)
    y0 = pb.eqn.init(pb.t0, pb.params)
    rows, cols = detect_sparsity(pb.eqn.rhs, pb.t0, y0, pb.params, 5)
    blocks = detect_blocks(rows, cols, 5)
    assert blocks is not None
    perm, nb, K = blocks
    assert (nb, K) == (3, 2)
    import dataclasses

    from diffsol_tpu.equations import OdeEquations

    eqn2 = dataclasses.replace(
        pb.eqn, rhs_jac=make_blockdiag_jac(pb.eqn.rhs, perm, nb, K, 5)
    )
    pblk = dataclasses.replace(
        pb, eqn=eqn2, linear_solver=make_blockdiag_solver(perm, nb, K, 5)
    )
    t_eval = jnp.asarray([0.5, 1.0, 2.0])
    sol_b = dt.solve_dense(dt.BdfSolver(pblk), t_eval, max_steps=2000)
    sol_d = dt.solve_dense(dt.BdfSolver(pb), t_eval, max_steps=2000)
    assert int(sol_b.stop_reason) >= 0
    np.testing.assert_allclose(
        np.asarray(sol_b.ys), np.asarray(sol_d.ys), rtol=1e-6, atol=1e-10
    )


def test_blockdiag_lockstep_ensemble():
    """Blockdiag composes with lockstep ensembles: the block axis K and the
    member axis B fuse into ONE (nb, nb, K*B) batch-last LU stack (the
    reference robertson_ode duplicated-groups layout under the nbatch
    context, cuda/lu.rs:69-96).
    Member-wise results match independent single-instance solves."""
    from diffsol_tpu.drivers import solve_dense
    from diffsol_tpu.ensemble import solve_dense_ensemble
    from diffsol_tpu.solvers.bdf import BdfSolver

    problem = robertson.problem_ode_groups(5)
    assert problem.linear_solver.name == "blockdiag(3,5)"
    B = 4
    base = np.asarray(problem.params, dtype=np.float64)
    f = 1.0 + 0.05 * np.linspace(-1.0, 1.0, B)[:, None]
    pb = jnp.asarray(base[None, :] * f)
    t_eval = jnp.asarray([1.0, 100.0, 1e4])

    sol = solve_dense_ensemble(
        BdfSolver, problem, t_eval, pb, mode="lockstep", max_steps=20_000
    )
    assert sol.ys.shape == (3, B, 15)

    solver = BdfSolver(problem)
    for b in range(B):
        one = solve_dense(
            solver, t_eval, params=pb[b], max_steps=20_000
        )
        np.testing.assert_allclose(
            np.asarray(sol.ys[:, b, :]), np.asarray(one.ys),
            rtol=2e-3, atol=1e-10,
        )
