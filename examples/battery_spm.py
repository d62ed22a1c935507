"""Physics-based battery simulation: SPM discharge at several currents.

Equivalent of reference examples/physics-based-battery-simulation: the
pybamm-generated single-particle-model DiffSL text (the reference book's
spm.ds, 42 states) solved over a current sweep with a terminal-voltage
stop condition -- the reference's set_params + root-stop loop becomes a
per-current solve with the root function halting at the voltage cutoff.

Run: JAX_PLATFORMS=cpu python examples/battery_spm.py
(needs the read-only reference mount for the spm.ds model text)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

import diffsol_tpu as dt
from diffsol_tpu.compile_cache import configure_compile_cache

# whole-solve compiles dominate; cache them across runs
configure_compile_cache()

SPM_PATH = "/root/reference/book/src/primer/src/spm.ds"


def main():
    if not os.path.exists(SPM_PATH):
        print("reference spm.ds not mounted; skipping")
        return
    src = open(SPM_PATH).read()
    model = dt.compile_diffsl(src)
    print(f"SPM model: {model.nstates} states, "
          f"params {[p[0] for p in model.param_labels]}")

    final_time = 3600.0
    # ONE problem/solver; the current is a traced parameter, so the whole
    # sweep reuses a single compiled solve (the reference re-creates the
    # solver per current; set_params plays this role there)
    problem = (
        dt.OdeBuilder().p([1.0]).rtol(1e-6).atol(1e-8).build_from_eqn(model)
    )
    solver = dt.BdfSolver(problem)
    for current in (0.6, 0.8, 1.0, 1.2, 1.4):
        sol = dt.solve(
            solver, final_time, params=jnp.asarray([current]), max_steps=2000
        )
        npts = int(sol.n_points)
        pcur = jnp.asarray([current])
        vs = jax.jit(
            jax.vmap(lambda tt, yy: problem.eqn.out(tt, yy, pcur)[0])
        )(sol.ts[:npts], sol.ys[:npts])
        # near full discharge the sqrt-SOC terms leave their domain within
        # the last step; report the last finite voltage on the trajectory
        import numpy as np

        vn = np.asarray(vs)
        k_last = int(np.flatnonzero(np.isfinite(vn))[-1])
        t_end = float(sol.ts[k_last])
        v_end = float(vn[k_last])
        if int(sol.stop_reason) == 1:
            stopped = "voltage cutoff"
        elif k_last < npts - 1:
            stopped = "fully discharged"  # SOC left the sqrt domain in-step
        else:
            stopped = "t_final"
        print(f"I = {current:.1f} A: discharged to t = {t_end:7.1f} s "
              f"({stopped}), V = {v_end:.3f} V")
        assert 2.0 < v_end < 4.5


if __name__ == "__main__":
    main()
