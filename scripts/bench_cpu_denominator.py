"""Framework-on-CPU denominators for bench.py (run in a subprocess with
``JAX_PLATFORMS=cpu``, so that only the bench process opens the GPU).

Prints ONE JSON line: single-instance wall times (best-of) for the bench
workloads, solved by THIS framework on the host CPU -- an XLA-compiled-RHS
CPU baseline (no Python-callback inflation; same numerics both sides, so
the ratio isolates the hardware).

Budget-aware (round-5 gate hardening): `DIFFSOL_CPU_DEN_BUDGET_S` bounds
the wall clock; rows run cheapest-first, each behind a remaining-budget
check, and the JSON line is printed in a `finally:` so partial results
always reach the parent.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import json
import time

T0 = time.monotonic()
BUDGET_S = float(_os.environ.get("DIFFSOL_CPU_DEN_BUDGET_S", "600"))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

OUT = {}


def remaining():
    return BUDGET_S - (time.monotonic() - T0)


def best_of(run, n=3):
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def row(name, est_s, fn):
    if remaining() < est_s:
        OUT[name + "_skipped_budget"] = True
        return
    try:
        OUT[name] = fn()
    except Exception as e:  # noqa: BLE001
        OUT[name + "_error"] = repr(e)[:120]


def rob():
    # robertson single instance, headline tolerances, t to 4e5
    from diffsol_tpu.drivers import solve_dense
    from diffsol_tpu.models import robertson
    from diffsol_tpu.solvers.bdf import BdfSolver

    te = jnp.asarray([0.4, 4.0, 40.0, 400.0, 4000.0, 4.0e4, 4.0e5])
    prob = robertson.problem_ode(rtol=1e-4, atol=(1e-8, 1e-6, 1e-6))
    solver = BdfSolver(prob)

    def run():
        s = solve_dense(solver, te, max_steps=5000)
        s.ys.block_until_ready()
        assert int(s.stop_reason) >= 0

    run()  # compile
    return best_of(run)


def heat2d_row():
    from diffsol_tpu.drivers import solve_dense
    from diffsol_tpu.models import heat2d
    from diffsol_tpu.solvers.bdf import BdfSolver

    hprob = heat2d.make(mgrid=20)
    hsolver = BdfSolver(hprob)
    hte = jnp.asarray([0.01, 0.03, 0.1])

    def run():
        s = solve_dense(hsolver, hte, max_steps=2000)
        s.ys.block_until_ready()
        assert int(s.stop_reason) >= 0

    run()
    return best_of(run)


def foodweb_row():
    from diffsol_tpu.drivers import solve_dense
    from diffsol_tpu.models import foodweb
    from diffsol_tpu.solvers.bdf import BdfSolver

    fprob = foodweb.make(nx=10)
    fsolver = BdfSolver(fprob)
    fte = jnp.asarray([1e-3, 1e-2, 1e-1])

    def run():
        s = solve_dense(fsolver, fte, max_steps=3000)
        s.ys.block_until_ready()
        assert int(s.stop_reason) >= 0

    run()
    return best_of(run)


def heat1d_row():
    # heat1d mgrid=127 (n=128) single instance: the matched denominator for
    # the banded lockstep ensemble row (heat1d_n128_b1024 in bench.py).
    # NB: the banded tier must be selected AT BUILD (the builder wires the
    # ml+mu+1 colored-probe band Jacobian); post-build
    # problem.replace(linear_solver=...) leaves a dense rhs_jac that the
    # band factorization misreads.
    from diffsol_tpu.drivers import solve_dense
    from diffsol_tpu.models.heat1d import make as _h1make
    from diffsol_tpu.ops.banded import make_banded_solver
    from diffsol_tpu.problem import OdeBuilder
    from diffsol_tpu.solvers.bdf import BdfSolver

    _h1base, _ = _h1make(mgrid=127)
    h1prob = (
        OdeBuilder()
        .rhs(_h1base.eqn.rhs)
        .init(_h1base.eqn.init)
        .p([1.0])
        .rtol(1e-6)
        .atol(1e-8)
        .linear_solver(make_banded_solver(1, 1, kernel="xla"))
        .build()
    )
    h1solver = BdfSolver(h1prob)
    h1te = jnp.asarray([0.001, 0.01, 0.05, 0.1, 0.2])

    def run():
        s = solve_dense(h1solver, h1te, max_steps=2000)
        s.ys.block_until_ready()
        assert int(s.stop_reason) >= 0

    run()
    return best_of(run)


def main():
    row("robertson_b1_s", 40, rob)
    row("heat1d_n128_b1_s", 60, heat1d_row)
    row("heat2d_b1_s", 60, heat2d_row)
    row("foodweb_b1_s", 90, foodweb_row)


if __name__ == "__main__":
    try:
        main()
    finally:
        print(json.dumps(OUT), flush=True)
