"""Flagship workload: 10k-member stiff Robertson parameter sweep.

The reference solves ensembles via its CUDA nbatch context on one GPU;
here it is a lockstep BDF ensemble: one shared adaptive step sequence over
a batch-last (3, nbatch) state.

Run: python examples/robertson_ensemble.py [nbatch]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

import diffsol_tpu as dt
from diffsol_tpu.models import robertson


def main():
    nbatch = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    problem = robertson.problem_ode()
    k1 = 0.04 * (1.0 + 0.1 * jnp.linspace(-1.0, 1.0, nbatch))
    params = jnp.stack(
        [k1, jnp.full((nbatch,), 1.0e4), jnp.full((nbatch,), 3.0e7)], axis=1
    )
    t_eval = jnp.asarray([0.4, 4.0, 400.0, 4.0e4, 4.0e5])

    # jit the whole ensemble solve: the first call compiles, the second
    # reuses the compiled program
    solve = jax.jit(lambda pb: dt.solve_dense_ensemble(
        dt.BdfSolver, problem, t_eval, pb, mode="lockstep", max_steps=5000
    ))
    t0 = time.perf_counter()
    sol = jax.block_until_ready(solve(params))
    compile_and_run = time.perf_counter() - t0

    t0 = time.perf_counter()
    sol = jax.block_until_ready(solve(params))
    run = time.perf_counter() - t0

    print(f"devices: {jax.devices()}")
    print(f"{nbatch} members x {len(t_eval)} outputs: "
          f"first call {compile_and_run:.2f}s, steady state {run:.3f}s "
          f"({run / nbatch * 1e6:.1f} us/instance)")
    cons = float(jnp.max(jnp.abs(sol.ys.sum(-1) - 1.0)))
    print(f"max conservation error across ensemble: {cons:.2e}")


if __name__ == "__main__":
    main()
