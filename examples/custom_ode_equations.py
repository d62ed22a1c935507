"""Hand-built equations object, bypassing the OdeBuilder closures.

Equivalent of reference examples/custom-ode-equations (src/my_equations.rs
et al.): the reference implements the OdeEquations trait family by hand --
rhs op with an explicit jac_mul, mass op, init op, root op, out op -- and
feeds it to OdeBuilder::build_from_eqn.  The JAX analog constructs
:class:`diffsol_tpu.OdeEquations` directly with an explicit ``rhs_jac``
(overriding the default jacfwd) and assembles the :class:`OdeProblem`
dataclass without the builder.

The model is the reference example's: logistic growth with a scaling mass
matrix, a root at y = 0.6, and out = 2y.

Run: python examples/custom_ode_equations.py
"""

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

import diffsol_tpu as dt
from diffsol_tpu.problem import OdeProblem


def main():
    # p = [r, k]: dy/dt = r*y*(1 - y/k), M = I (the reference's MyMass is
    # the identity application), y0 = 0.1, root at y - 0.6, out = 2y
    def rhs(t, y, p):
        return p[0] * y * (1.0 - y / p[1])

    def rhs_jac(t, y, p):
        # explicit dense Jacobian, the analog of MyRhs's hand-written
        # jac_mul (my_rhs_impl_nonlinear.rs) -- no AD involved
        return jnp.diag(p[0] * (1.0 - 2.0 * y / p[1]))

    def mass(t, p):
        return jnp.eye(1)

    def init(t, p):
        return jnp.array([0.1])

    def root(t, y, p):
        return jnp.array([y[0] - 0.6])

    def out(t, y, p):
        return 2.0 * y

    eqn = dt.OdeEquations(
        rhs=rhs,
        init=init,
        mass=mass,
        root=root,
        out=out,
        rhs_jac=rhs_jac,
        nstates=1,
        nout=1,
        nroots=1,
        nparams=2,
    )
    params = jnp.array([1.0, 10.0])
    problem = OdeProblem(
        eqn=eqn,
        params=params,
        t0=jnp.asarray(0.0),
        h0=jnp.asarray(0.0),
        rtol=jnp.asarray(1e-8),
        atol=jnp.full((1,), 1e-10),
    )

    solver = dt.BdfSolver(problem)
    sol = dt.solve(solver, 10.0)
    n = int(sol.n_points)
    # the root at y = 0.6 stops the adaptive solve (no reset op): check
    # against the analytic logistic crossing time
    y_final = float(sol.ys[n - 1, 0])
    t_final = float(sol.ts[n - 1])
    r, k = 1.0, 10.0
    y0 = 0.1
    t_expect = float(
        np.log((0.6 / (k - 0.6)) / (y0 / (k - y0))) / r
    )
    assert abs(y_final - 0.6) < 1e-6, y_final
    assert abs(t_final - t_expect) < 1e-6, (t_final, t_expect)
    print(
        f"custom equations: root y=0.6 found at t={t_final:.6f} "
        f"(analytic {t_expect:.6f}), explicit-Jacobian path exercised"
    )


if __name__ == "__main__":
    main()
