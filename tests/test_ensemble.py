"""Ensemble solving: lockstep (reference nbatch parity) and independent
(vmap) modes, with and without mesh sharding over virtual devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import diffsol_tpu as dt
from diffsol_tpu import errors
from diffsol_tpu.models import exponential_decay, robertson


def _params_batch(nb):
    a = jnp.linspace(0.05, 1.0, nb)
    return jnp.stack([a, jnp.ones_like(a)], axis=1)


@pytest.mark.parametrize("mode", ["lockstep", "independent"])
def test_ensemble_exponential_decay(mode):
    problem = exponential_decay.problem(rtol=1e-6, atol=1e-8)
    t_eval = jnp.linspace(0.0, 1.0, 7)
    params = _params_batch(16)
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, params, mode=mode
    )
    assert sol.ys.shape == (16, 7, 2) or sol.ys.shape == (7, 16, 2)
    ys = sol.ys if sol.ys.shape[0] == 16 else jnp.moveaxis(sol.ys, 1, 0)
    for i in range(16):
        expected = exponential_decay.soln(t_eval, params[i])
        np.testing.assert_allclose(ys[i], expected, rtol=1e-4, atol=1e-6)


def test_lockstep_shares_steps():
    """Lockstep: one shared adaptive h; step count equals a single solve of
    the WORST member (max-norm reduction across the batch)."""
    problem = exponential_decay.problem(rtol=1e-6, atol=1e-8)
    t_eval = jnp.linspace(0.0, 1.0, 5)
    params = _params_batch(4)
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, params, mode="lockstep"
    )
    # scalar statistics (shared across batch)
    assert sol.state.stats.steps.ndim == 0
    assert int(sol.stop_reason) == errors.TSTOP_REACHED


def test_lockstep_robertson_dae():
    """Batched stiff DAE: 32 Robertson instances with perturbed rates."""
    problem = robertson.problem_dae()
    nb = 32
    k1 = 0.04 * (1.0 + 0.1 * jnp.linspace(-1, 1, nb))
    params = jnp.stack(
        [k1, jnp.full((nb,), 1.0e4), jnp.full((nb,), 3.0e7)], axis=1
    )
    t_eval = jnp.asarray(robertson.SOLN[1:6, 0])
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, params, mode="lockstep", max_steps=20_000
    )
    assert int(sol.stop_reason) == errors.TSTOP_REACHED
    ys = np.asarray(sol.ys)  # (neval, nb, 3)
    assert ys.shape == (5, nb, 3)
    # the middle member has the nominal k1: compare against reference data
    mid = nb // 2
    k_mid = float(params[mid, 0])
    # conservation holds for every member at every time
    np.testing.assert_allclose(ys.sum(axis=-1), 1.0, rtol=1e-6)
    # monotone consistency: larger k1 -> faster x decay
    assert np.all(np.diff(ys[-1, :, 0]) < 0)


def test_sharded_ensemble_runs():
    """Mesh-sharded ensemble over the 8 virtual CPU devices."""
    devices = np.array(jax.devices()[:8]).reshape(8)
    mesh = Mesh(devices, ("dp",))
    problem = exponential_decay.problem(rtol=1e-6, atol=1e-8)
    t_eval = jnp.linspace(0.0, 1.0, 5)
    params = _params_batch(32)
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, params, mode="lockstep", mesh=mesh
    )
    assert int(sol.stop_reason) == errors.TSTOP_REACHED
    ys = jnp.moveaxis(sol.ys, 1, 0)
    for i in [0, 15, 31]:
        expected = exponential_decay.soln(t_eval, params[i])
        np.testing.assert_allclose(ys[i], expected, rtol=1e-4, atol=1e-6)


def test_lockstep_banded_heat1d():
    """Lockstep ensemble over the banded linear-solver tier (heat1d MOL
    with varying diffusivities)."""
    import dataclasses
    from diffsol_tpu.models import heat1d
    from diffsol_tpu.ops.banded import make_banded_jac, make_banded_solver

    problem, soln = heat1d.make(mgrid=12)
    eqn = dataclasses.replace(
        problem.eqn, rhs_jac=make_banded_jac(problem.eqn.rhs, 1, 1)
    )
    problem = dataclasses.replace(
        problem, eqn=eqn, linear_solver=make_banded_solver(1, 1)
    )
    nb = 4
    d_values = jnp.asarray([1.0, 1.0, 0.5, 2.0])
    params = d_values[:, None]
    t_eval = jnp.asarray([0.51, 0.53])
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, params, mode="lockstep"
    )
    assert int(sol.stop_reason) == errors.TSTOP_REACHED
    ys = np.asarray(sol.ys)  # (neval, nb, n)
    assert ys.shape == (2, nb, 13)
    # members 0 and 1 share D=1: identical; the analytic solution checks out
    np.testing.assert_allclose(ys[:, 0], ys[:, 1], rtol=1e-12)
    # 13-point grid: ~2.5% spatial discretization error vs the continuum
    expected = soln(np.asarray(t_eval))
    np.testing.assert_allclose(ys[:, 0], expected, rtol=5e-2)
    # faster diffusion decays more: max of member 3 < member 2 at t end
    assert ys[-1, 3].max() < ys[-1, 2].max()
    # each member against the exact solution of its linear semi-discrete
    # ODE y' = d A y (matrix exponential)
    import scipy.linalg

    n = ys.shape[-1]
    a = np.asarray(jax.jacfwd(problem.eqn.rhs, argnums=1)(
        0.0, jnp.zeros(n), jnp.asarray([1.0])))
    y0 = np.asarray(problem.eqn.init(0.0, problem.params))
    for m, d in enumerate(np.asarray(d_values)):
        exact_m = np.stack([scipy.linalg.expm(d * tt * a) @ y0
                            for tt in np.asarray(t_eval)])
        np.testing.assert_allclose(ys[:, m], exact_m, rtol=1e-4, atol=1e-6)


def test_state_sharded_large_mol_halo():
    """Large-n MOL state sharding (SURVEY aux row 'state-vector sharding'):
    an n=1024 heat1d ERK step sharded over a (dp=2, sp=4) mesh must (a)
    match the unsharded solve bit-for-bit and (b) actually lower to XLA
    collectives for the stencil halo + norm reductions -- asserted on the
    compiled HLO, not just by running."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from diffsol_tpu.ensemble import make_lockstep_problem
    from diffsol_tpu.models import heat1d
    from diffsol_tpu.solvers.erk import ErkSolver

    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("dp", "sp"))
    problem, _ = heat1d.make(mgrid=1023)  # n = 1024
    lp = make_lockstep_problem(problem, 2)
    solver = ErkSolver(lp)
    params = lp.params
    state0 = solver.init_state(params)

    def five_steps(state, params):
        return jax.lax.fori_loop(
            0, 5, lambda i, st: solver.step(st, params), state
        )

    ref = jax.jit(five_steps)(state0, params)

    y_shard = NamedSharding(mesh, P("sp", "dp"))
    state_sh = state0.replace(
        y=jax.device_put(state0.y, y_shard),
        dy=jax.device_put(state0.dy, y_shard),
    )
    params_sh = jax.device_put(params, NamedSharding(mesh, P("dp", None)))
    fn = jax.jit(five_steps)
    out = fn(state_sh, params_sh)
    assert int(out.stats.steps) == 5
    np.testing.assert_array_equal(np.asarray(ref.y), np.asarray(out.y))

    hlo = fn.lower(state_sh, params_sh).compile().as_text()
    assert any(
        op in hlo
        for op in ("all-reduce", "all-gather", "collective-permute",
                   "reduce-scatter")
    ), "no collectives in the sharded-step HLO"


def test_worst_member_diagnostic():
    """Shared-fate lockstep failures name the culprit: stats.worst_member is
    the member whose WRMS term dominated the most recent error test
    (diffsol_tpu.norms.worst_member; extension beyond the reference's
    counters)."""
    from diffsol_tpu.ensemble import make_lockstep_problem

    problem = exponential_decay.problem(rtol=1e-8, atol=1e-10)
    nb = 8
    lp = make_lockstep_problem(problem, nb)
    # member 5 is 100x stiffer than the rest: it controls the shared step
    rates = np.full(nb, 0.1)
    rates[5] = 10.0
    params = jnp.stack(
        [jnp.asarray(rates), jnp.ones(nb)], axis=1
    ).astype(lp.params.dtype)
    solver = dt.BdfSolver(lp)
    sol = dt.solve_dense(
        solver, jnp.asarray([0.5, 1.0]), params=params, max_steps=2000
    )
    assert int(sol.stop_reason) >= 0
    assert int(sol.state.stats.worst_member) == 5


def test_f32_lockstep_ensemble():
    """The f32 precision tier composes with lockstep ensembles (benchmarked
    in bench.py): conservation holds and members match the f64 lockstep
    solve to ~rtol."""
    from diffsol_tpu.ensemble import make_lockstep_problem
    from diffsol_tpu.models import robertson

    def build(dtype=None):
        return robertson.problem_ode(rtol=1e-4, atol=1e-6, dtype=dtype)

    nb = 8
    k1 = 0.04 * (1.0 + 0.1 * np.linspace(-1.0, 1.0, nb))

    def solve(problem):
        lp = make_lockstep_problem(problem, nb)
        params = jnp.stack(
            [jnp.asarray(k1), jnp.full(nb, 1.0e4), jnp.full(nb, 3.0e7)],
            axis=1,
        ).astype(lp.params.dtype)
        return dt.solve_dense(
            dt.BdfSolver(lp), jnp.asarray([0.4, 40.0], lp.atol.dtype),
            params=params, max_steps=5000,
        )

    s32 = solve(build(jnp.float32))
    s64 = solve(build())
    assert s32.ys.dtype == jnp.float32
    assert int(s32.stop_reason) >= 0
    np.testing.assert_allclose(
        np.asarray(s32.ys, dtype=np.float64).sum(axis=1), 1.0, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s32.ys, dtype=np.float64), np.asarray(s64.ys),
        rtol=0, atol=2e-4,
    )


def test_lockstep_root_finding_bouncing_ball():
    """Lockstep root+reset with IDENTICAL member dynamics: shared root
    times, member-wise match with the single-instance solve (reference
    batched root_finding semantics, vector/cuda.rs + tests
    vector/mod.rs:835-844)."""
    from diffsol_tpu.drivers import solve_dense

    def build(lockstep_b=None):
        b = (
            dt.OdeBuilder()
            .rhs(lambda t, y, p: jnp.stack([y[1], -p[0] * jnp.ones_like(y[1])]))
            .init(lambda t, p: jnp.array([10.0, 0.0]))
            .root(lambda t, y, p: y[0:1])
            .reset(lambda t, y, p: jnp.stack([jnp.full_like(y[0], 1e-9),
                                              -p[1] * y[1]]))
            .p([9.81, 0.8])
            .rtol(1e-8)
            .atol(1e-10)
        )
        problem = b.build()
        if lockstep_b is None:
            return problem
        return make_lockstep_problem(problem, lockstep_b)

    from diffsol_tpu.ensemble import make_lockstep_problem

    B = 5
    t_eval = jnp.asarray([0.5, 1.0, 2.0, 3.0])
    single = build()
    lp = build(B)
    pb = jnp.broadcast_to(single.params, (B, 2))
    sol_b = solve_dense(dt.BdfSolver(lp), t_eval, params=pb, max_steps=4000)
    assert int(sol_b.stop_reason) >= 0
    sol_1 = solve_dense(dt.BdfSolver(single), t_eval, max_steps=4000)
    for b in range(B):
        np.testing.assert_allclose(
            np.asarray(sol_b.ys[:, :, b]), np.asarray(sol_1.ys),
            rtol=1e-6, atol=1e-8,
        )
    # independent reference: free fall, one bounce at t1 = sqrt(2 h / g)
    # restarting at 0.8 of the impact speed (the next one is at t = 3.7)
    g, t = 9.81, np.asarray(t_eval)
    t1 = np.sqrt(2.0 * 10.0 / g)
    v1 = 0.8 * g * t1
    s = t - t1
    exact = np.where(
        t < t1,
        np.stack([10.0 - 0.5 * g * t * t, -g * t]),
        np.stack([1e-9 + v1 * s - 0.5 * g * s * s, v1 - g * s]),
    ).T  # (neval, 2)
    np.testing.assert_allclose(
        np.asarray(sol_b.ys[:, :, 0]), exact, rtol=1e-5, atol=1e-6
    )


def test_lockstep_root_inconsistent_fails_loudly():
    """Members whose events would fire at (detectably) different times must
    fail with ROOT_BATCH_INCONSISTENT, not silently pick one time (the
    reference panics here, vector/cuda.rs:1166-1175)."""
    from diffsol_tpu import errors
    from diffsol_tpu.drivers import solve_dense

    # threshold crossing of exponential decay: root time = ln(y0/c)/a
    # differs strongly across members when a differs
    problem = (
        dt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y)
        .init(lambda t, p: jnp.array([1.0]))
        .root(lambda t, y, p: y[0:1] - 0.5)
        .reset(lambda t, y, p: jnp.ones_like(y))
        .p([1.0])
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )
    from diffsol_tpu.ensemble import make_lockstep_problem

    B = 3
    lp = make_lockstep_problem(problem, B)
    pb = jnp.asarray([[0.5], [1.0], [2.0]])  # very different decay rates
    sol = solve_dense(dt.BdfSolver(lp), jnp.asarray([1.0, 3.0]), params=pb,
                      max_steps=4000)
    assert int(sol.stop_reason) == errors.ROOT_BATCH_INCONSISTENT


def test_independent_ensemble_with_reset_events():
    """Independent (vmap) ensembles carry per-member event sequences: each
    bouncing ball bounces at ITS OWN times (heterogeneous gravity), unlike
    lockstep's shared-root requirement."""
    problem = (
        dt.OdeBuilder()
        .rhs(lambda t, y, p: jnp.stack([y[1], -p[0] * jnp.ones_like(y[1])]))
        .init(lambda t, p: jnp.array([10.0, 0.0]))
        .root(lambda t, y, p: y[0:1])
        .reset(lambda t, y, p: jnp.stack([jnp.full_like(y[0], 1e-9),
                                          -0.8 * y[1]]))
        .p([9.81])
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )
    gs = jnp.asarray([[6.0], [9.81], [15.0]])  # very different bounce times
    t_eval = jnp.asarray([0.5, 1.5, 2.5])
    sol = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, gs, mode="independent",
        max_steps=4000,
    )
    ys = np.asarray(sol.ys)  # (neval, B, 2)
    from diffsol_tpu.drivers import solve_dense

    for b in range(3):
        one = solve_dense(
            dt.BdfSolver(problem), t_eval, params=gs[b], max_steps=4000
        )
        np.testing.assert_allclose(
            ys[:, b], np.asarray(one.ys), rtol=1e-6, atol=1e-7
        )


def test_solution_tier_field():
    """Solution.tier surfaces which ensemble semantics produced the result:
    one shared step sequence (lockstep) or one per member (independent)."""
    problem = exponential_decay.problem(rtol=1e-6, atol=1e-8)
    t_eval = jnp.linspace(0.0, 1.0, 5)
    params = _params_batch(8)
    sol_l = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, params, mode="lockstep"
    )
    assert sol_l.tier == "lockstep"
    assert sol_l.state.stats.steps.ndim == 0
    sol_i = dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, params, mode="independent"
    )
    assert sol_i.tier == "independent"
    assert sol_i.state.stats.steps.shape == (8,)
