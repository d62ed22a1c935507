"""Benchmark rows of the lockstep ensemble solver on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...extras}.  The run refuses any backend but a GPU.

* **Wall-clock budget** (`DIFFSOL_BENCH_BUDGET_S`, default 1100 s):
  checked before every row; skipped rows emit a `<row>_skipped_budget` key.
* **Partial results always emitted**: every completed row lands in one
  accumulator dict; the JSON line is printed in a `finally:` AND from a
  SIGTERM/SIGINT handler, so an external `timeout` still captures every
  row measured so far.
* Per-row wall times are reported as `secs_<row>` keys.

Workloads (provenance in each row fn):
* robertson stiff-ODE lockstep ensembles at the reference's robertson_ode
  tolerances (reference crates/diffsol/src/ode_equations/test_models/
  robertson_ode.rs:56-60), incl. the REFERENCE-MATCHED t=4e10 config
  against the published ngroups=10k row
  (book/src/benchmarks/python_results.csv "10000,0.0001" = 0.1340 s);
* heat2d/foodweb/heat1d banded MOL problems with measured LSODA/CPU-XLA
  denominators.

Timing: each solve is compiled once, then timed as the median of three
runs, each around ``block_until_ready``.
"""

import json
import os
import signal
import sys
import time

T0 = time.monotonic()
BUDGET_S = float(os.environ.get("DIFFSOL_BENCH_BUDGET_S", "1100"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# f64 for stiff-tolerance parity (before the package builds any constant)
jax.config.update("jax_enable_x64", True)

NBATCH = 10_000
# reference robertson_ode output decades within our t-span (robertson_ode.rs)
T_EVAL = [0.4, 4.0, 40.0, 400.0, 4000.0, 4.0e4, 4.0e5]
T_EVAL_4E10 = [4.0 * 10.0**k for k in range(-1, 11)]  # 0.4 ... 4e10

# Reference-published measured total wall time for robertson_ode with
# ngroups=10,000 (one 30k-state sparse-BDF solve to t=4e10), single host,
# book/src/benchmarks/python_results.csv row "10000,0.0001": 0.1340 s.
DIFFSOL_NGROUPS10K_S = 0.1340123851162692
DIFFSOL_NGROUPS1000_S = 0.012448280966944164

# ---------------------------------------------------------------------------
# result accumulator + always-emit machinery
# ---------------------------------------------------------------------------

R = {}
_EMITTED = False


def emit():
    global _EMITTED
    if _EMITTED:
        return
    _EMITTED = True
    out = {
        "metric": R.pop(
            "metric", "robertson_10k_lockstep_ensemble_per_instance"
        ),
        "value": R.pop("value", None),
        "unit": R.pop("unit", "us"),
        "vs_baseline": R.pop("vs_baseline", None),
    }
    out.update(R)
    print(json.dumps(out), flush=True)


def _on_signal(signum, frame):
    R["terminated_by_signal"] = int(signum)
    R["elapsed_s"] = round(time.monotonic() - T0, 1)
    emit()
    os._exit(0)


def remaining():
    return BUDGET_S - (time.monotonic() - T0)


def row(name, est_s, fn):
    """Run one bench row if the remaining budget covers its estimated cold
    cost; record its wall time; isolate failures to the row."""
    if remaining() < est_s:
        R[f"{name}_skipped_budget"] = round(remaining(), 1)
        print(f"bench: SKIP {name} (need ~{est_s}s, "
              f"{remaining():.0f}s left)", file=sys.stderr)
        return False
    t0 = time.monotonic()
    try:
        fn()
        return True
    except Exception as e:  # noqa: BLE001 - a row must not kill the bench
        R[f"{name}_error"] = repr(e)[:200]
        return False
    finally:
        R[f"secs_{name}"] = round(time.monotonic() - t0, 1)
        print(f"bench: {name} in {R[f'secs_{name}']}s "
              f"({remaining():.0f}s left)", file=sys.stderr)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def timed(run, params, reps=3):
    """Median seconds of ``reps`` runs of a compiled solve, each timed
    around ``block_until_ready`` (the first call compiles)."""
    jax.block_until_ready(run(params))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(params))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# Published peaks by device_kind: NVIDIA H100 Tensor Core GPU datasheet,
# SXM5 part, dense rates without sparsity, at its 700 W power limit.  A
# device that is not in this table gets no utilization keys.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "float64_flops": 34.0e12,  # FP64 outside the tensor cores
        "float32_flops": 67.0e12,  # FP32 outside the tensor cores
        "hbm_bytes_s": 3.35e12,
    },
}


def peaks(device_kind):
    """The published peak rates of ``device_kind``, or None if unknown."""
    return PEAKS.get(device_kind)


def step_cost(solver, params):
    """(flops, bytes accessed) of the jitted single-step program via XLA's
    cost model.  While-loop bodies (the Newton/attempt loops) are counted
    ONCE, so these are per-step lower bounds."""
    from diffsol_tpu.drivers import init_state_jit

    state = init_state_jit(solver, params)
    c = jax.jit(solver.step).lower(state, params).compile().cost_analysis()
    if isinstance(c, (list, tuple)):
        c = c[0] if c else {}
    return float(c.get("flops", 0.0)), float(c.get("bytes accessed", 0.0))


def mfu_keys(tag, solver, params, total_s, steps):
    """flops/bytes per step and their shares of the device's published
    peaks (none when the device is not in :data:`PEAKS`)."""
    peak = peaks(jax.devices()[0].device_kind)
    try:
        flops, bts = step_cost(solver, params)
    except Exception:
        return {}
    sec_per_step = total_s / max(steps, 1)
    out = {f"flops_per_step_{tag}": flops, f"bytes_per_step_{tag}": bts}
    if peak is not None:
        dtype = jnp.dtype(solver.problem.params.dtype).name
        out[f"mfu_{tag}"] = flops / sec_per_step / peak[f"{dtype}_flops"]
        out[f"hbm_util_{tag}"] = bts / sec_per_step / peak["hbm_bytes_s"]
    return out


# ---------------------------------------------------------------------------
# CPU baselines (LSODA; cheap, measured on this host)
# ---------------------------------------------------------------------------


def measure_lsoda(rtol, atol, nsolve=30):
    """Single-thread LSODA on this host, same problem/t_eval/tolerances."""
    from scipy.integrate import odeint

    def rhs(y, t, k1, k2, k3):
        return [
            -k1 * y[0] + k2 * y[1] * y[2],
            k1 * y[0] - k2 * y[1] * y[2] - k3 * y[1] ** 2,
            k3 * y[1] ** 2,
        ]

    t_eval = np.concatenate([[0.0], T_EVAL])
    y0 = [1.0, 0.0, 0.0]
    odeint(rhs, y0, t_eval, args=(0.04, 1e4, 3e7), rtol=rtol, atol=atol)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(nsolve):
            k1 = 0.04 * (1.0 + 0.1 * (2.0 * i / nsolve - 1.0))
            odeint(rhs, y0, t_eval, args=(k1, 1e4, 3e7), rtol=rtol, atol=atol)
        best = min(best, (time.perf_counter() - t0) / nsolve)
    return best


def measure_lsoda_nfe(rtol, atol):
    """(nfe per solve, measured per-callback seconds) for the robertson
    LSODA baseline -- used to report a Python-callback-overhead-corrected
    estimate of a compiled-RHS LSODA."""
    from scipy.integrate import odeint

    def rhs(y, t, k1, k2, k3):
        return [
            -k1 * y[0] + k2 * y[1] * y[2],
            k1 * y[0] - k2 * y[1] * y[2] - k3 * y[1] ** 2,
            k3 * y[1] ** 2,
        ]

    t_eval = np.concatenate([[0.0], T_EVAL])
    y0 = [1.0, 0.0, 0.0]
    _, info = odeint(
        rhs, y0, t_eval, args=(0.04, 1e4, 3e7), rtol=rtol, atol=atol,
        full_output=True,
    )
    nfe = int(info["nfe"][-1])
    yv = [0.5, 0.3, 0.2]
    t0 = time.perf_counter()
    for _ in range(20000):
        rhs(yv, 0.0, 0.04, 1e4, 3e7)
    per_cb = (time.perf_counter() - t0) / 20000
    return nfe, per_cb


def measure_lsoda_heat2d(mgrid, t_eval, rtol, atol, nsolve=5):
    """LSODA (banded-Jacobian mode) on the interior-point ODE reduction of
    heat2d: the compiled-CPU denominator for the banded tier."""
    from scipy.integrate import odeint

    m = mgrid - 2  # interior points per side
    dx = 1.0 / (mgrid - 1)
    coeff = 1.0 / (dx * dx)
    ii = np.arange(mgrid) * dx
    x, yv = np.meshgrid(ii[1:-1], ii[1:-1], indexing="ij")
    u0 = (16.0 * x * (1.0 - x) * yv * (1.0 - yv)).reshape(-1)

    def rhs(u, t):
        g = np.zeros((m + 2, m + 2))
        g[1:-1, 1:-1] = u.reshape(m, m)
        lap = (
            g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2] + g[1:-1, 2:]
            - 4.0 * g[1:-1, 1:-1]
        ) * coeff
        return lap.reshape(-1)

    te = np.concatenate([[0.0], t_eval])
    odeint(rhs, u0, te, rtol=rtol, atol=atol, ml=m, mu=m)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _i in range(nsolve):
            odeint(rhs, u0, te, rtol=rtol, atol=atol, ml=m, mu=m)
        best = min(best, (time.perf_counter() - t0) / nsolve)
    return best


# ---------------------------------------------------------------------------
# workload runners
# ---------------------------------------------------------------------------


def run_robertson(rtol, atol, nbatch=NBATCH, dtype=None, t_eval=None,
                  spread=True, max_steps=5000):
    from diffsol_tpu.ensemble import make_lockstep_problem
    from diffsol_tpu.drivers import solve_dense
    from diffsol_tpu.models import robertson
    from diffsol_tpu.solvers.bdf import BdfSolver

    # dtype=float32 is the f32 tier (reference ScalarType::F32):
    # trajectories agree with f64 to ~rtol
    problem = robertson.problem_ode(rtol=rtol, atol=atol, dtype=dtype)
    lp = make_lockstep_problem(problem, nbatch)
    if spread:
        k1 = 0.04 * (1.0 + 0.1 * jnp.linspace(-1.0, 1.0, nbatch))
    else:  # reference-matched: every group shares the same parameters
        k1 = jnp.full((nbatch,), 0.04)
    params = jnp.stack(
        [k1, jnp.full((nbatch,), 1.0e4), jnp.full((nbatch,), 3.0e7)], axis=1
    ).astype(lp.params.dtype)
    solver = BdfSolver(lp)
    te = jnp.asarray(t_eval if t_eval is not None else T_EVAL)

    def run(pb):
        # state=None: init is folded into the jitted solve (ONE dispatch)
        return solve_dense(solver, te, params=pb, max_steps=max_steps)

    run = jax.jit(run)
    sol = jax.block_until_ready(run(params))
    assert int(sol.stop_reason) >= 0, f"solve failed: {int(sol.stop_reason)}"
    # sanity: mass conservation across the ensemble (ys is (neval, 3, B))
    cons = float(jnp.max(jnp.abs(sol.ys.sum(axis=1) - 1.0)))
    assert cons < 1e-3, f"conservation violated: {cons}"
    # trajectory sanity vs the reference's CVODE/IDA table (robertson.rs)
    soln = robertson.SOLN
    mid = nbatch // 2 if spread else 0
    for r_ in range(1, 4):  # t = 0.4, 4, 40
        got = float(sol.ys[r_ - 1, 0, mid])
        want = float(soln[r_, 1])
        rel = abs(got - want) / want
        assert rel < 2e-2, f"trajectory off at t={soln[r_,0]}: {got} vs {want}"
    return timed(run, params), int(sol.state.stats.steps), solver, params


def run_banded_dae(make_problem, t_eval, nbatch=32, max_steps=2000,
                   params=None):
    """MOL banded lockstep workload; returns (seconds, steps, solver,
    params)."""
    from diffsol_tpu.ensemble import make_lockstep_problem
    from diffsol_tpu.drivers import solve_dense
    from diffsol_tpu.solvers.bdf import BdfSolver

    problem = make_problem()
    lp = make_lockstep_problem(problem, nbatch)
    if params is None:
        params = jnp.broadcast_to(problem.params, (nbatch,) + problem.params.shape)
    params = jnp.asarray(params, lp.params.dtype)
    solver = BdfSolver(lp)
    te = jnp.asarray(t_eval)

    def run(pb):
        return solve_dense(solver, te, params=pb, max_steps=max_steps)

    run = jax.jit(run)
    sol = jax.block_until_ready(run(params))
    assert int(sol.stop_reason) >= 0, f"banded solve failed: {int(sol.stop_reason)}"
    return timed(run, params), int(sol.state.stats.steps), solver, params


def bench_simple(problem, t_eval, nbatch=1000, max_steps=2000):
    from diffsol_tpu.ensemble import make_lockstep_problem
    from diffsol_tpu.drivers import solve_dense as _sdense
    from diffsol_tpu.solvers.bdf import BdfSolver as _B

    lp = make_lockstep_problem(problem, nbatch)
    pb = jnp.broadcast_to(
        problem.params, (nbatch,) + problem.params.shape
    ).astype(lp.params.dtype)
    sv = _B(lp)

    def run(p):
        return _sdense(sv, jnp.asarray(t_eval), params=p,
                       max_steps=max_steps)

    run = jax.jit(run)
    s = jax.block_until_ready(run(pb))
    assert int(s.stop_reason) >= 0
    return timed(run, pb)


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


def row_headline():
    lsoda_hi = measure_lsoda(1e-4, 1e-6)
    nfe_hi, per_cb = measure_lsoda_nfe(1e-4, 1e-6)
    lsoda_hi_compiled_est = max(lsoda_hi - nfe_hi * per_cb, 1e-9)
    t_hi, steps_hi, solver_hi, params_hi = run_robertson(1e-4, 1e-6)
    per_hi = t_hi / NBATCH
    R["metric"] = "robertson_10k_lockstep_ensemble_per_instance"
    R["value"] = round(per_hi * 1e6, 3)
    R["unit"] = "us"
    R["vs_baseline"] = round(lsoda_hi / per_hi, 2)
    R["baseline"] = "lsoda_measured_this_host_same_tol"
    R["baseline_us"] = round(lsoda_hi * 1e6, 1)
    R["rtol"] = 1e-4
    R["total_s"] = round(t_hi, 4)
    # LSODA denominator honesty: measured per-callback cost x nfe,
    # subtracted -- the compiled-RHS LSODA estimate
    R["baseline_lsoda_nfe"] = nfe_hi
    R["baseline_callback_us"] = round(per_cb * 1e6, 3)
    R["baseline_compiled_est_us"] = round(lsoda_hi_compiled_est * 1e6, 1)
    R["vs_baseline_compiled_est"] = round(lsoda_hi_compiled_est / per_hi, 2)
    R.update(mfu_keys("robertson_b10k", solver_hi, params_hi, t_hi, steps_hi))


def row_matched_t4e10():
    # reference-matched: shared params, the reference's own t-span to 4e10
    t_m64, _, _, _ = run_robertson(
        1e-4, 1e-6, t_eval=T_EVAL_4E10, spread=False
    )
    R["vs_diffsol_t4e10"] = round(DIFFSOL_NGROUPS10K_S / t_m64, 2)
    R["matched_t4e10_total_s"] = round(t_m64, 4)


def row_matched_t4e10_f32():
    t_m32, _, _, _ = run_robertson(
        1e-4, 1e-6, t_eval=T_EVAL_4E10, spread=False, dtype=jnp.float32
    )
    R["vs_diffsol_t4e10_f32"] = round(DIFFSOL_NGROUPS10K_S / t_m32, 2)
    R["matched_t4e10_f32_total_s"] = round(t_m32, 4)


def row_heat1d_band():
    """Banded lockstep ensemble (medium-n MOL): heat1d n=128 x B=1024
    heterogeneous diffusivities, ml = mu = 1."""
    import dataclasses

    from diffsol_tpu.models import heat1d as _h1
    from diffsol_tpu.ops.banded import make_banded_jac, make_banded_solver

    base, _ = _h1.make(mgrid=127, rtol=1e-6, atol=1e-8)
    h1prob = dataclasses.replace(
        base,
        eqn=dataclasses.replace(
            base.eqn, rhs_jac=make_banded_jac(base.eqn.rhs, 1, 1)),
        linear_solver=make_banded_solver(1, 1),
    )
    B_band = 1024
    h1te = [0.001, 0.01, 0.05, 0.1, 0.2]
    pband = jnp.linspace(0.5, 2.0, B_band)[:, None]
    t_band, _, _, _ = run_banded_dae(lambda: h1prob, h1te, nbatch=B_band,
                                     max_steps=5000, params=pband)
    R["heat1d_n128_b1024_total_s"] = t_band
    R["heat1d_n128_per_inst_us"] = t_band / B_band * 1e6
    R["heat1d_n128_linear_solver"] = h1prob.linear_solver.name


def row_rtol1e6():
    lsoda_lo = measure_lsoda(1e-6, 1e-8)
    t_lo, _, _, _ = run_robertson(1e-6, 1e-8)
    per_lo = t_lo / NBATCH
    R["value_rtol1e6"] = round(per_lo * 1e6, 3)
    R["vs_baseline_rtol1e6"] = round(lsoda_lo / per_lo, 2)
    R["baseline_rtol1e6_us"] = round(lsoda_lo * 1e6, 1)


def row_blockdiag():
    # unstructured-sparse (block-dense) tier: the reference's robertson_ode
    # ngroups workload as ONE n=3000 problem (3x3 blocks on the lanes);
    # published diffsol: python_results.csv "1000,0.0001" = 0.012448 s
    from diffsol_tpu.drivers import solve_dense as _sd
    from diffsol_tpu.models.robertson import problem_ode_groups
    from diffsol_tpu.solvers.bdf import BdfSolver as _Bdf

    pgrp = problem_ode_groups(1000, rtol=1e-4, atol=(1e-8, 1e-6, 1e-6))
    assert pgrp.linear_solver.name == "blockdiag(3,1000)"
    gsolver = _Bdf(pgrp)
    te10 = jnp.asarray(T_EVAL_4E10)

    def run_grp(pb):
        return _sd(gsolver, te10, params=pb, max_steps=5000)

    run_grp = jax.jit(run_grp)
    sol_g = jax.block_until_ready(run_grp(pgrp.params))
    assert int(sol_g.stop_reason) >= 0, int(sol_g.stop_reason)
    t_grp = timed(run_grp, pgrp.params)
    R["robertson_ode_ngroups1000_total_s"] = round(t_grp, 4)
    R["vs_diffsol_ngroups1000"] = round(DIFFSOL_NGROUPS1000_S / t_grp, 3)


def row_blockdiag_lockstep():
    # blockdiag x lockstep: ngroups=100 per member x B=100 members, all
    # 10,000 group-instances in ONE (3,3,K*B) batch-last blockdiag stack --
    # the same total workload as the reference's published ngroups=10k row
    from diffsol_tpu.drivers import solve_dense as _sd
    from diffsol_tpu.ensemble import make_lockstep_problem as _mklock
    from diffsol_tpu.models.robertson import problem_ode_groups
    from diffsol_tpu.solvers.bdf import BdfSolver as _Bdf

    te10 = jnp.asarray(T_EVAL_4E10)
    pgrp100 = problem_ode_groups(100, rtol=1e-4, atol=(1e-8, 1e-6, 1e-6))
    lp_grp = _mklock(pgrp100, 100)
    pb_grp = jnp.broadcast_to(
        pgrp100.params, (100,) + pgrp100.params.shape
    ).astype(lp_grp.params.dtype)
    gsolver2 = _Bdf(lp_grp)

    def run_grp_lock(pb):
        return _sd(gsolver2, te10, params=pb, max_steps=5000)

    run_grp_lock = jax.jit(run_grp_lock)
    sol_gl = jax.block_until_ready(run_grp_lock(pb_grp))
    assert int(sol_gl.stop_reason) >= 0, int(sol_gl.stop_reason)
    t_grp_lock = timed(run_grp_lock, pb_grp)
    R["robertson_ode_g100xb100_total_s"] = round(t_grp_lock, 4)
    R["robertson_ode_g100xb100_per_group_us"] = round(
        t_grp_lock / 10_000 * 1e6, 3
    )
    R["vs_diffsol_ngroups10k_blockdiag_lockstep"] = round(
        DIFFSOL_NGROUPS10K_S / t_grp_lock, 2
    )


def row_sweep():
    # ensemble-size sweep (reference book/src/benchmarks/python.md ngroups
    # table: per-instance time vs batch size)
    for b in (100, 1000):
        tb, sb, sv, pb = run_robertson(1e-4, 1e-6, nbatch=b)
        R[f"per_instance_us_b{b}"] = round(tb / b * 1e6, 2)
        if b == 1000:
            R.update(mfu_keys("robertson_b1k", sv, pb, tb, sb))


def row_f32():
    t_hi = R.get("total_s")
    t_f32, _, _, _ = run_robertson(1e-4, 1e-6, dtype=jnp.float32)
    R["per_instance_us_f32"] = round(t_f32 / NBATCH * 1e6, 3)
    if t_hi:
        R["f32_vs_f64_speedup"] = round(t_hi / t_f32, 2)


def row_b100k():
    t_100k, s_100k, sv_100k, p_100k = run_robertson(
        1e-4, 1e-6, nbatch=100_000
    )
    R["per_instance_us_b100k"] = round(t_100k / 100_000 * 1e6, 3)
    R.update(mfu_keys("robertson_b100k", sv_100k, p_100k, t_100k, s_100k))


def row_b100k_f32():
    t_100k32, _, _, _ = run_robertson(
        1e-4, 1e-6, nbatch=100_000, dtype=jnp.float32
    )
    R["per_instance_us_b100k_f32"] = round(t_100k32 / 100_000 * 1e6, 3)


def row_heat2d():
    from diffsol_tpu.models import heat2d

    heat_te = [0.01, 0.03, 0.1]
    heat_s, heat_steps, heat_solver, heat_params = run_banded_dae(
        lambda: heat2d.make(mgrid=20), heat_te
    )
    R["heat2d_mgrid20_b32_total_s"] = round(heat_s, 4)
    R["heat2d_mgrid20_b32_steps"] = heat_steps
    R["heat2d_per_instance_ms"] = round(heat_s / 32 * 1e3, 3)
    R.update(mfu_keys("heat2d_b32", heat_solver, heat_params, heat_s,
                      heat_steps))
    heat_cpu = measure_lsoda_heat2d(20, heat_te, 1e-5, 1e-5)
    R["heat2d_cpu_lsoda_banded_ms"] = round(heat_cpu * 1e3, 2)
    R["heat2d_vs_cpu"] = round(heat_cpu / (heat_s / 32), 2)


def row_foodweb():
    from diffsol_tpu.models import foodweb

    food_s, food_steps, _, _ = run_banded_dae(
        lambda: foodweb.make(nx=10), [1e-3, 1e-2, 1e-1], max_steps=3000
    )
    R["foodweb_nx10_b32_total_s"] = round(food_s, 4)
    R["foodweb_nx10_b32_steps"] = food_steps


def row_ci_simple():
    # reference CI bench problems (ode_solvers_ci.rs:15-120):
    # exponential_decay and heat1d as lockstep ensembles
    from diffsol_tpu.models import exponential_decay, heat1d

    t_exp = bench_simple(exponential_decay.problem(rtol=1e-4, atol=1e-6),
                         [0.25, 0.5, 0.75, 1.0])
    R["exponential_decay_b1000_per_instance_us"] = round(
        t_exp / 1000 * 1e6, 3
    )
    t_h1d = bench_simple(heat1d.make(mgrid=21)[0], [0.1, 0.5, 1.0], nbatch=32)
    R["heat1d_mgrid21_b32_total_s"] = round(t_h1d, 4)


def row_cpu_denominators():
    """Framework-on-CPU single-instance times via a forced-cpu subprocess
    (scripts/bench_cpu_denominator.py): the XLA-compiled-RHS CPU baseline
    class.  Budget-aware: the subprocess gets the remaining budget (minus
    margin) and emits partial results itself."""
    import subprocess

    sub_budget = max(min(remaining() - 60.0, 600.0), 60.0)
    env = dict(os.environ)
    env["DIFFSOL_CPU_DEN_BUDGET_S"] = str(sub_budget)
    # the child stays off the GPU: one JAX process per card
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "scripts/bench_cpu_denominator.py"],
        capture_output=True, text=True, timeout=sub_budget + 60,
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    cpu_den = json.loads(out.stdout.strip().splitlines()[-1])
    for k, v in cpu_den.items():
        if isinstance(v, (int, float)):
            R[k + "_cpu_xla_ms"] = round(v * 1e3, 3)
    # cross-ratios against rows already measured
    if cpu_den.get("heat2d_b1_s") and R.get("heat2d_mgrid20_b32_total_s"):
        R["heat2d_vs_cpu_xla"] = round(
            cpu_den["heat2d_b1_s"]
            / (R["heat2d_mgrid20_b32_total_s"] / 32), 2
        )
    if cpu_den.get("foodweb_b1_s") and R.get("foodweb_nx10_b32_total_s"):
        R["foodweb_vs_cpu_xla"] = round(
            cpu_den["foodweb_b1_s"] / (R["foodweb_nx10_b32_total_s"] / 32), 2
        )
    if cpu_den.get("robertson_b1_s") and R.get("total_s"):
        R["robertson_vs_cpu_xla"] = round(
            cpu_den["robertson_b1_s"] / (R["total_s"] / NBATCH), 2
        )
    if (cpu_den.get("heat1d_n128_b1_s")
            and R.get("heat1d_n128_b1024_total_s")):
        R["heat1d_n128_band_vs_cpu_xla"] = (
            cpu_den["heat1d_n128_b1_s"]
            / (R["heat1d_n128_b1024_total_s"] / 1024)
        )


def require_gpu():
    """The first device must be a GPU: there is no CPU fallback."""
    devs = jax.devices()
    print(f"bench: devices={devs}", file=sys.stderr)
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX's first device is {devs[0].platform}"
        )
    return devs


def main():
    from diffsol_tpu.compile_cache import configure_compile_cache

    devs = jax.devices()
    R["device"] = {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)}
    configure_compile_cache()
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    R["budget_s"] = BUDGET_S

    # --- rows: cheapest-and-most-important first; est_s are cold-compile
    # estimates (not yet calibrated on the GPU)
    row("headline", 150, row_headline)
    row("matched_t4e10", 100, row_matched_t4e10)
    row("heat1d_band", 100, row_heat1d_band)
    row("matched_t4e10_f32", 90, row_matched_t4e10_f32)
    row("blockdiag_lockstep", 120, row_blockdiag_lockstep)
    row("rtol1e6", 110, row_rtol1e6)
    row("f32", 80, row_f32)
    row("sweep", 150, row_sweep)
    row("heat2d", 120, row_heat2d)
    row("ci_simple", 130, row_ci_simple)
    row("blockdiag", 100, row_blockdiag)
    row("foodweb", 110, row_foodweb)
    row("b100k", 140, row_b100k)
    row("b100k_f32", 90, row_b100k_f32)
    row("cpu_denominators", 150, row_cpu_denominators)


if __name__ == "__main__":
    require_gpu()
    try:
        main()
    except Exception as e:  # noqa: BLE001
        R["bench_error"] = repr(e)[:300]
        raise
    finally:
        R["elapsed_s"] = round(time.monotonic() - T0, 1)
        emit()
