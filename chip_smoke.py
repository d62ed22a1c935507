"""Run the solver's main path once on one GPU and check every result.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Each phase goes through the public entry points (``import diffsol_tpu as
dt``: an ``OdeBuilder`` problem, a solver, ``solve_dense`` or
``solve_dense_ensemble``) at the sizes the reference's users run, and holds
its result to an independent reference with a stated bound.  One JSON line
is printed per phase (errors, bounds and their reasons, compile and run
seconds, peak device memory, the card's name and power limit); the last
line is ``{"ok": true, "device": {...}}`` and is printed only when every
phase passed.  There is no CPU fallback: the script fails unless JAX's
first device is a GPU.

Every bound was set from a CPU run of the same phase at a small batch
(``JAX_PLATFORMS=cpu``, see ``tests/test_chip_smoke.py``) and is the same
on the GPU.  Compile seconds are trace + lower + compile of the phase's
jitted program; run seconds are the second execution of the compiled
program, timed around ``block_until_ready``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

# before the package builds any constant: every phase but robertson_f32 is f64
jax.config.update("jax_enable_x64", True)

import diffsol_tpu as dt  # noqa: E402
from diffsol_tpu.compile_cache import configure_compile_cache  # noqa: E402
from diffsol_tpu.models import foodweb, heat1d, heat2d, robertson  # noqa: E402
from diffsol_tpu.ops.banded import (  # noqa: E402
    dense_to_band,
    make_banded_jac,
    make_banded_solver,
)

# the reference's robertson_ode output decades (robertson.rs:119-133)
T_EVAL_4E10 = [4.0 * 10.0**k for k in range(-1, 11)]
ROBERTSON_ATOL = np.asarray([1e-8, 1e-6, 1e-6])
F64_EPS = float(np.finfo(np.float64).eps)


class PhaseFailed(RuntimeError):
    pass


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------


def card_info() -> str:
    """``name, power.limit`` of the card(s), read by nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(line.strip() for line in out.stdout.splitlines())


def compile_and_run(fn, *args):
    """(outputs, timing, compiled): trace+lower+compile, a first run, and
    the timed second run."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t1 = time.perf_counter()
    jax.block_until_ready(compiled(*args))
    t2 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t3 = time.perf_counter()
    return out, {"compile_s": t1 - t0, "first_run_s": t2 - t1,
                 "run_s": t3 - t2}, compiled


def median_time(fn, *args, reps=20):
    """Median seconds of ``reps`` runs of an already compiled ``fn``."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def rel_err(got, ref, floor):
    """max |got - ref| / max(|ref|, floor): relative error, with the
    absolute tolerance as the floor for components that decay to 0."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), floor)))


def tol_err(got, ref, rtol, atol):
    """max |got - ref| / (atol + rtol |ref|): the error in units of the
    solver's own per-component tolerance (its WRMS weight)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / (atol + rtol * np.abs(ref))))


def check(name, err, bound, reason):
    return {"name": name, "err": float(err), "bound": float(bound),
            "reason": reason, "ok": bool(np.isfinite(err) and err <= bound)}


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _status_ok(sol):
    status = int(sol.stop_reason)
    if status < 0:
        raise PhaseFailed(f"solver stopped with status {status}")


# --------------------------------------------------------------------------
# references
# --------------------------------------------------------------------------


def radau_robertson(k, t_eval):
    """scipy Radau (rtol 1e-10, atol 1e-14) on one robertson member."""
    from scipy.integrate import solve_ivp

    k1, k2, k3 = (float(v) for v in k)

    def f(t, y):
        r = k2 * y[1] * y[2]
        s = k3 * y[1] * y[1]
        return [-k1 * y[0] + r, k1 * y[0] - r - s, s]

    def jac(t, y):
        return [[-k1, k2 * y[2], k2 * y[1]],
                [k1, -k2 * y[2] - 2.0 * k3 * y[1], -k2 * y[1]],
                [0.0, 2.0 * k3 * y[1], 0.0]]

    sol = solve_ivp(f, (0.0, t_eval[-1]), [1.0, 0.0, 0.0], method="Radau",
                    t_eval=t_eval, rtol=1e-10, atol=1e-14, jac=jac)
    if not sol.success:
        raise PhaseFailed(f"Radau reference failed: {sol.message}")
    return sol.y.T  # (neval, 3)


def heat1d_expm(problem, d, t_eval):
    """Exact solution of the linear semi-discrete heat1d ODE, y' = d A y."""
    from scipy.linalg import expm

    n = problem.eqn.nstates
    y0 = np.asarray(problem.eqn.init(0.0, problem.params), np.float64)
    a = np.asarray(jax.jacfwd(problem.eqn.rhs, argnums=1)(
        0.0, jnp.zeros(n), jnp.asarray([1.0])), np.float64)
    return np.stack([expm(d * t * a) @ y0 for t in t_eval])


# --------------------------------------------------------------------------
# phases (one GPU)
# --------------------------------------------------------------------------


def robertson_params(nbatch, dtype=jnp.float64):
    """k1 spread +-5 % over the batch; the middle member at the defaults."""
    k1 = 0.04 * (1.0 + 0.05 * np.linspace(-1.0, 1.0, nbatch))
    k1[nbatch // 2] = robertson.P_DEFAULT[0]
    p = np.stack([k1, np.full(nbatch, 1.0e4), np.full(nbatch, 3.0e7)], 1)
    return jnp.asarray(p, dtype)


def lockstep_solve(problem, t_eval, params, max_steps):
    """The program ``solve_dense_ensemble(mode="lockstep")`` runs, with the
    solver built outside ``jit`` (DAE solvers read the mass matrix on the
    host) so that the solve itself is compiled once and timed.  Returns
    (ys as (neval, B, n), solution, timing, compiled)."""
    solver = dt.BdfSolver(dt.make_lockstep_problem(problem, params.shape[0]))

    def run(pb):
        return dt.solve_dense(solver, t_eval, params=pb, max_steps=max_steps)

    sol, timing, compiled = compile_and_run(run, params)
    _status_ok(sol)
    return np.moveaxis(np.asarray(sol.ys, np.float64), -1, 1), sol, timing, \
        compiled


def _robertson_lockstep(nbatch, dtype=None, t_eval=T_EVAL_4E10):
    problem = robertson.problem_ode(rtol=1e-4, dtype=dtype)
    params = robertson_params(nbatch, problem.params.dtype)
    t_eval = jnp.asarray(t_eval, problem.params.dtype)
    ys, sol, timing, compiled = lockstep_solve(problem, t_eval, params, 5000)
    return ys, params, sol, timing, compiled


def step_trace(compiled, params, steps):
    """Kernel launches per step and device idle share of one traced run of
    a compiled lockstep solve."""
    with tempfile.TemporaryDirectory() as tmp:
        with jax.profiler.trace(tmp):
            jax.block_until_ready(compiled(params))
        launches, copies, busy, window, top = device_kernel_events(tmp)
    return {"launches": launches, "launches_per_step": launches / steps,
            "memcpys_per_step": copies / steps,
            "device_busy_s": busy * 1e-9, "trace_window_s": window * 1e-9,
            "idle_share": 1.0 - busy / window if window else None,
            "top_kernels_us": top}


def phase_robertson_f64(nbatch=10_000, nref=16):
    """The lockstep ensemble, and its XLA step program's seconds and
    kernel launches per step from one profiler trace."""
    ys, params, sol, timing, compiled = _robertson_lockstep(nbatch)
    steps = int(sol.state.stats.steps)
    trace = step_trace(compiled, params, steps)
    params = np.asarray(params)
    mid = nbatch // 2
    idx = np.unique(np.linspace(0, nbatch - 1, nref).astype(int))
    radau = np.stack([radau_robertson(params[i], T_EVAL_4E10) for i in idx])
    checks = [
        check("cvode_points", tol_err(ys[:, mid], robertson.SOLN[1:, 1:],
                                      1e-4, ROBERTSON_ATOL), 20.0,
              "error in units of the solver tolerance (atol + rtol|y|): "
              "the table itself is up to 2.7 units off a 1e-10 Radau "
              "solve; CPU f64 at B=64 reads 5.6"),
        check("radau_members", tol_err(np.moveaxis(ys[:, idx], 1, 0), radau,
                                       1e-4, ROBERTSON_ATOL), 10.0,
              "error in units of the solver tolerance against a 1e-10 "
              "Radau solve per member: global error of a stiff rtol=1e-4 "
              "BDF solve is a few units; CPU f64 at B=64 reads 3.4"),
        check("mass_conservation", np.max(np.abs(ys.sum(-1) - 1.0)), 1e-10,
              "y1+y2+y3 is a linear invariant BDF keeps to roundoff times "
              "the Newton tolerance; CPU f64 at B=64 reads 4.9e-15"),
    ]
    if jax.default_backend() == "gpu":
        checks.append(check(
            "kernels_traced", 0.0 if trace["launches"] else np.inf, 0.0,
            "the trace holds the solve's device kernels"))
    extra = {"nbatch": nbatch, "steps": steps,
             "s_per_step": timing["run_s"] / steps, **trace}
    return checks, timing, extra, ys


# f32 Newton fails (TOO_MANY_NONLINEAR_SOLVER_FAILURES) past t ~ 1.5e10 on
# the CPU, so the f32 solve stops one decade earlier, at 4e9
T_EVAL_F32 = T_EVAL_4E10[:-1]


def phase_robertson_f32(ys64, nbatch=10_000):
    ys, _params, sol, timing, _ = _robertson_lockstep(
        nbatch, jnp.float32, T_EVAL_F32)
    checks = [
        check("vs_f64_members", tol_err(ys, ys64[:len(T_EVAL_F32)], 1e-4,
                                        ROBERTSON_ATOL), 10.0,
              "error in units of the solver tolerance between the f32 "
              "solve (HIGHEST-precision matmuls) and the f64 one, each a "
              "few units off the truth; CPU at B=64 reads 2.6"),
        check("mass_conservation", np.max(np.abs(ys.sum(-1) - 1.0)), 1e-4,
              "linear invariant to f32 roundoff accumulated over the steps "
              "(eps 1.2e-7); CPU at B=64 reads 4.0e-6"),
    ]
    extra = {"nbatch": nbatch, "t_end": T_EVAL_F32[-1],
             "steps": int(sol.state.stats.steps)}
    return checks, timing, extra


def _with_kernel(problem, kernel, interpret):
    ml, mu = problem.linear_solver.meta[:2]
    return dataclasses.replace(
        problem,
        linear_solver=make_banded_solver(ml, mu, kernel, interpret=interpret),
    )


def phase_heat2d_banded(mgrid=20, nbatch=32, interpret=False):
    base = heat2d.make(mgrid=mgrid)
    if not interpret and base.linear_solver.meta[2] != "triton":
        raise PhaseFailed(f"auto routing chose {base.linear_solver.name}")
    t_eval = jnp.asarray([0.01, 0.03, 0.1])
    params = jnp.ones((nbatch, 1))
    ys_t, sol_t, tim_t, _ = lockstep_solve(
        _with_kernel(base, "triton", interpret), t_eval, params, 2000)
    ys_x, sol_x, tim_x, _ = lockstep_solve(
        _with_kernel(base, "xla", False), t_eval, params, 2000)
    n = mgrid * mgrid
    idx = np.arange(n)
    boundary = ((idx % mgrid == 0) | (idx % mgrid == mgrid - 1)
                | (idx // mgrid == 0) | (idx // mgrid == mgrid - 1))
    checks = [
        check("triton_vs_xla_kernel", rel_err(ys_t, ys_x, 1e-5), 1e-6,
              "same f64 solve, two no-pivot band LUs that differ only in "
              "roundoff; 1e-6 is a tenth of rtol=1e-5; CPU (interpret) at "
              "mgrid=8 B=2 reads 0.0"),
        check("dirichlet_rows", np.max(np.abs(ys_t[..., boundary])), 1e-8,
              "algebraic boundary rows u=0 hold to the Newton tolerance"),
    ]
    timing = dict(tim_t, xla_run_s=tim_x["run_s"],
                  xla_compile_s=tim_x["compile_s"])
    extra = {"mgrid": mgrid, "n": n, "nbatch": nbatch,
             "steps": int(sol_t.state.stats.steps),
             "steps_xla": int(sol_x.state.stats.steps)}
    return checks, timing, extra


def phase_heat1d_banded(mgrid=127, nbatch=1024, interpret=False):
    base, _ = heat1d.make(mgrid=mgrid, rtol=1e-6, atol=1e-8)
    t_eval = [0.001, 0.01, 0.05, 0.1, 0.2]
    d = np.linspace(0.5, 2.0, nbatch)
    params = jnp.asarray(d[:, None])

    def banded(kernel, interp):
        return dataclasses.replace(
            base,
            eqn=dataclasses.replace(
                base.eqn, rhs_jac=make_banded_jac(base.eqn.rhs, 1, 1)),
            linear_solver=make_banded_solver(1, 1, kernel, interpret=interp),
        )

    te = jnp.asarray(t_eval)
    ys_t, sol_t, tim_t, _ = lockstep_solve(
        banded("triton", interpret), te, params, 5000)
    ys_x, sol_x, tim_x, _ = lockstep_solve(banded("xla", False), te, params,
                                          5000)
    members = np.unique(np.linspace(0, nbatch - 1, 4).astype(int))
    exact = np.stack([heat1d_expm(base, d[m], t_eval) for m in members], 1)
    checks = [
        check("triton_vs_xla_kernel", rel_err(ys_t, ys_x, 1e-8), 1e-6,
              "same f64 solve, two no-pivot band LUs that differ only in "
              "roundoff; CPU (interpret) at n=16 B=4 reads 0.0"),
        check("expm_members", rel_err(ys_t[:, members], exact, 1e-3), 1e-4,
              "rtol=1e-6 BDF against the exact matrix exponential of the "
              "linear semi-discrete ODE (floor 1e-3 of a unit-height "
              "profile); CPU at n=16 B=4 reads 6.2e-6"),
    ]
    timing = dict(tim_t, xla_run_s=tim_x["run_s"],
                  xla_compile_s=tim_x["compile_s"])
    extra = {"n": mgrid + 1, "nbatch": nbatch,
             "steps": int(sol_t.state.stats.steps)}
    return checks, timing, extra


def random_band(n, ml, mu, nbatch, seed=0):
    """Diagonally dominant random band systems, batch-last (nb, n, B)."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    a = rng.standard_normal((nbatch, n, n))
    inside = ((i[None, :] - i[:, None] <= mu)
              & (i[:, None] - i[None, :] <= ml))
    a = a * inside
    a[:, i, i] = np.abs(a).sum(-1) + 1.0
    band = np.stack([np.asarray(dense_to_band(m, ml, mu)) for m in a], -1)
    return a, band


def phase_band_lu(shapes=((400, 20, 20, 32), (128, 1, 1, 1024)),
                  interpret=False):
    """Factor + solve alone with each kernel, and their f64 difference."""
    checks, timing, extra = [], {}, {}
    rng = np.random.default_rng(1)
    for n, ml, mu, nbatch in shapes:
        _, band = random_band(n, ml, mu, nbatch)
        band = jnp.asarray(band)
        b = jnp.asarray(rng.standard_normal((n, nbatch)))
        xs = {}
        for kernel in ("triton", "xla"):
            spec = make_banded_solver(
                ml, mu, kernel, interpret=interpret and kernel == "triton")

            def fs(a, rhs, spec=spec):
                return spec.solve(spec.factor(a), rhs)

            compiled = jax.jit(fs).lower(band, b).compile()
            xs[kernel] = np.asarray(compiled(band, b))
            timing[f"{kernel}_n{n}_b{nbatch}_s"] = median_time(compiled,
                                                               band, b)
        err = float(np.max(np.abs(xs["triton"] - xs["xla"]))
                    / np.max(np.abs(xs["xla"])))
        bound = 10.0 * n * (ml + mu + 1) * F64_EPS
        checks.append(check(
            f"triton_vs_xla_n{n}_ml{ml}", err, bound,
            "no pivoting in either kernel; diagonally dominant systems "
            "(growth <= 2): the two differ by roundoff, <= 10 n (ml+mu+1) "
            "eps"))
    return checks, timing, extra


def phase_foodweb_dae(nx=10, nbatch=32):
    problem = foodweb.make(nx=nx)
    t_eval = jnp.asarray(foodweb.SOLN[1:, 0])
    params = jnp.ones((nbatch, 1))
    ys, sol, timing, _ = lockstep_solve(problem, t_eval, params, 20_000)
    corners = foodweb.corner_values(np.moveaxis(ys, 1, 0), nx)  # (B, t, 4)
    checks = [
        check("ida_corners", rel_err(corners, np.broadcast_to(
            foodweb.SOLN[1:, 1:], corners.shape), 1e-30), 2e-3,
            "the repo's foodweb bound (tests/test_models.py): IDA's table "
            "against BDF at rtol=atol=1e-5; CPU at B=2 reads 1.8e-5"),
    ]
    extra = {"nx": nx, "n": 2 * nx * nx, "nbatch": nbatch,
             "linear_solver": problem.linear_solver.name,
             "steps": int(sol.state.stats.steps)}
    return checks, timing, extra


def phase_robertson_ode_blockdiag(ngroups=1000):
    problem = robertson.problem_ode_groups(ngroups, rtol=1e-4)
    if problem.linear_solver.name != f"blockdiag(3,{ngroups})":
        raise PhaseFailed(f"routed to {problem.linear_solver.name}")
    solver = dt.BdfSolver(problem)
    t_eval = jnp.asarray(T_EVAL_4E10)

    def run(p):
        return dt.solve_dense(solver, t_eval, params=p, max_steps=5000)

    sol, timing, _ = compile_and_run(run, problem.params)
    _status_ok(sol)
    ys = np.asarray(sol.ys).reshape(len(T_EVAL_4E10), ngroups, 3)
    soln = np.broadcast_to(robertson.SOLN[1:, None, 1:], ys.shape)
    checks = [
        check("cvode_points_every_group",
              tol_err(ys, soln, 1e-4, ROBERTSON_ATOL), 20.0,
              "error in units of the solver tolerance, as robertson_f64's "
              "cvode_points; CPU at ngroups=4 reads 4.3"),
    ]
    extra = {"ngroups": ngroups, "n": 3 * ngroups,
             "linear_solver": problem.linear_solver.name,
             "steps": int(sol.state.stats.steps)}
    return checks, timing, extra


def spring_problem():
    """Damped spring y'' = -k y - c y', p = (k, c)."""
    return (
        dt.OdeBuilder()
        .rhs(lambda t, y, p: jnp.array([y[1], -p[0] * y[0] - p[1] * y[1]]))
        .init(lambda t, p: jnp.array([1.0, 0.0]))
        .p([2.0, 0.4])
        .rtol(1e-6)
        .atol(1e-8)
        .build()
    )


SPRING_T_EVAL = np.linspace(0.5, 3.0, 4)


def spring_fit_setup(nbatch):
    """(ys_of, loss, start params, data) of a per-member spring fit."""
    problem = spring_problem()
    t_eval = jnp.asarray(SPRING_T_EVAL)
    ys_of = dt.make_differentiable_solve_ensemble(
        problem, t_eval, nbatch, max_steps=1024)
    k_true = jnp.linspace(2.5, 3.5, nbatch)
    truth = jnp.stack([k_true, jnp.full((nbatch,), 0.25)], axis=1)
    data = ys_of(truth)
    pb = jnp.broadcast_to(jnp.asarray([2.0, 0.4]), (nbatch, 2))

    def loss(p):
        return jnp.mean((ys_of(p) - data) ** 2)

    return problem, loss, pb, data


def phase_adjoint_ensemble(nbatch=4096, ncheck=8):
    problem, loss, pb, data = spring_fit_setup(nbatch)
    (val, grad), timing, _ = compile_and_run(jax.value_and_grad(loss), pb)
    grad = np.asarray(grad)
    solver = dt.BdfSolver(problem)
    t_eval = jnp.asarray(SPRING_T_EVAL)

    def ys_plain(p):
        return dt.solve_dense(solver, t_eval, params=p, max_steps=4096).ys

    jac_fn = jax.jit(jax.jacfwd(ys_plain))
    scale = 2.0 / (nbatch * len(SPRING_T_EVAL) * 2)
    errs = []
    for b in np.unique(np.linspace(0, nbatch - 1, ncheck).astype(int)):
        jac = np.asarray(jac_fn(pb[b]))  # (neval, n, np)
        resid = np.asarray(ys_plain(pb[b])) - np.asarray(data)[:, b]
        g_fwd = scale * np.einsum("ij,ijk->k", resid, jac)
        errs.append(np.max(np.abs(grad[b] - g_fwd)) / np.max(np.abs(g_fwd)))
    checks = [
        check("vs_jacfwd_members", max(errs), 1e-3,
              "adjoint and forward-mode gradients of two rtol=1e-6 solves "
              "with different step sequences agree to ~rtol x 100; CPU at "
              "B=8 reads 5.0e-5"),
        check("loss_finite", 0.0 if np.isfinite(float(val)) else np.inf,
              0.0, "the loss of a converged fit is finite"),
    ]
    extra = {"nbatch": nbatch, "loss": float(val)}
    return checks, timing, extra


def device_kernel_events(trace_dir):
    """Reduce one profiler trace to its GPU stream events: (kernel launch
    count, memcpy count, busy ns, window ns, the kernels with the most
    device time as [name, count, total us])."""
    from jax.profiler import ProfileData

    paths = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    data = ProfileData.from_file(paths[0])
    kernels, copies, spans, per_name = 0, 0, [], {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                spans.append((e.start_ns, e.end_ns))
                if "memcpy" in e.name.lower() or "memset" in e.name.lower():
                    copies += 1
                    continue
                kernels += 1
                count, total = per_name.get(e.name, (0, 0.0))
                per_name[e.name] = (count + 1, total + e.duration_ns)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]
    top = [[name[:80], c, t * 1e-3] for name, (c, t) in top]
    if not spans:
        return kernels, copies, 0.0, 0.0, top
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    return kernels, copies, busy, spans[-1][1] - spans[0][0], top


# --------------------------------------------------------------------------
# --multi (four GPUs): the sharded paths, each against one device
# --------------------------------------------------------------------------


def multi_robertson_dp(devices, nbatch=10_000):
    from jax.sharding import Mesh

    problem = robertson.problem_ode(rtol=1e-4)
    params = robertson_params(nbatch)
    t_eval = jnp.asarray(T_EVAL_4E10)
    mesh = Mesh(np.asarray(devices), ("dp",))

    def solve(mesh_or_none, pb):
        return dt.solve_dense_ensemble(
            dt.BdfSolver, problem, t_eval, pb, mode="lockstep",
            mesh=mesh_or_none, max_steps=5000,
        )

    t0 = time.perf_counter()
    sharded = jax.block_until_ready(solve(mesh, params))
    t1 = time.perf_counter()
    with jax.default_device(devices[0]):
        one = jax.block_until_ready(solve(None, params))
    _status_ok(sharded)
    _status_ok(one)
    diff = tol_err(sharded.ys, one.ys, 1e-4, ROBERTSON_ATOL)
    checks = [check("sharded_vs_one_device", diff, 1e-6,
                    "error in units of the solver tolerance; the dp axis "
                    "only splits members and the shared step's max-norm is "
                    "order-independent, but the two programs are compiled "
                    "apart, so fusion can differ in the last bits: held to "
                    "a millionth of the tolerance; CPU (4 virtual devices, "
                    "B=8) reads up to 1.9e-8 with equal step counts")]
    extra = {"nbatch": nbatch, "bitwise": bool(np.array_equal(
        np.asarray(sharded.ys), np.asarray(one.ys))),
        "steps": [int(sharded.state.stats.steps),
                  int(one.state.stats.steps)],
        "sharded_first_call_s": t1 - t0}
    return checks, {}, extra


def multi_heat1d_dp_sp(devices, mgrid=255):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sp = 2
    dp = len(devices) // sp
    mesh = Mesh(np.asarray(devices).reshape(dp, sp), ("dp", "sp"))
    problem, _ = heat1d.make(mgrid=mgrid)
    lp = dt.make_lockstep_problem(problem, 2 * dp)
    solver = dt.ErkSolver(lp)

    def five_steps(state, params):
        return jax.lax.fori_loop(
            0, 5, lambda i, st: solver.step(st, params), state)

    with jax.default_device(devices[0]):
        state0 = solver.init_state(lp.params)
        ref = jax.block_until_ready(jax.jit(five_steps)(state0, lp.params))
    y_sh = NamedSharding(mesh, P("sp", "dp"))
    state_sh = state0.replace(y=jax.device_put(state0.y, y_sh),
                              dy=jax.device_put(state0.dy, y_sh))
    p_sh = jax.device_put(lp.params, NamedSharding(mesh, P("dp", None)))
    out = jax.block_until_ready(jax.jit(five_steps)(state_sh, p_sh))
    if int(out.stats.steps) != 5:
        raise PhaseFailed(f"{int(out.stats.steps)} steps, expected 5")
    diff = float(np.max(np.abs(np.asarray(out.y) - np.asarray(ref.y))))
    checks = [check("sharded_vs_one_device", diff, 1e-13,
                    "the halo exchange and norm collectives move values "
                    "without arithmetic; unit-height profile, so 1e-13 is "
                    "a few hundred ulps; CPU (4 virtual devices) reads 0.0")]
    extra = {"n": mgrid + 1, "dp": dp, "sp": sp,
             "bitwise": bool(np.array_equal(np.asarray(out.y),
                                            np.asarray(ref.y)))}
    return checks, {}, extra


def multi_training_step(devices, nbatch=4096):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.asarray(devices), ("dp",))
    _problem, loss, pb, _data = spring_fit_setup(nbatch)

    def train_step(p):
        val, grad = jax.value_and_grad(loss)(p)
        return val, p - 0.05 * grad

    with jax.default_device(devices[0]):
        val1, p1 = jax.block_until_ready(jax.jit(train_step)(pb))
    pb_sh = jax.device_put(pb, NamedSharding(mesh, P("dp")))
    val4, p4 = jax.block_until_ready(jax.jit(train_step)(pb_sh))
    diff = float(np.max(np.abs(np.asarray(p4) - np.asarray(p1)))
                 / np.max(np.abs(np.asarray(p1 - pb))))
    checks = [check("sharded_vs_one_device", diff, 1e-10,
                    "per-member forward and adjoint solves share one step "
                    "sequence set by an order-independent max-norm: "
                    "roundoff only, relative to the update; CPU (4 virtual "
                    "devices, B=8) reads 0.0")]
    extra = {"nbatch": nbatch, "loss_sharded": float(val4),
             "loss_one_device": float(val1)}
    return checks, {}, extra


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------


def final_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def run_phase(name, fn, card, *args, **kwargs):
    checks, timing, extra, *rest = fn(*args, **kwargs)
    ok = all(c["ok"] for c in checks)
    print(json.dumps({"phase": name, "ok": ok, "checks": checks,
                      "timing": timing, "peak_bytes_in_use": peak_bytes(),
                      "card": card, **extra}), flush=True)
    if not ok:
        raise PhaseFailed(f"phase {name} failed its checks")
    return rest[0] if rest else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: run only the sharded paths")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX's first device is "
            f"{devices[0].platform} ({devices[0].device_kind})")
    if args.multi and len(devices) != 4:
        raise SystemExit(f"--multi needs 4 GPUs, JAX sees {len(devices)}")
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache()
    card = card_info()
    print(card, flush=True)

    if args.multi:
        run_phase("multi_robertson_dp", multi_robertson_dp, card, devices)
        run_phase("multi_heat1d_dp_sp", multi_heat1d_dp_sp, card, devices)
        run_phase("multi_training_step", multi_training_step, card, devices)
    else:
        ys64 = run_phase("robertson_f64", phase_robertson_f64, card)
        run_phase("robertson_f32", phase_robertson_f32, card, ys64)
        run_phase("band_lu", phase_band_lu, card)
        run_phase("heat2d_banded", phase_heat2d_banded, card)
        run_phase("heat1d_banded", phase_heat1d_banded, card)
        run_phase("foodweb_dae", phase_foodweb_dae, card)
        run_phase("robertson_ode_blockdiag", phase_robertson_ode_blockdiag,
                  card)
        run_phase("adjoint_ensemble", phase_adjoint_ensemble, card)
    print(final_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
