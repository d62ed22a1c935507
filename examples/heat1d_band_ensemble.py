"""Medium-n MOL ensemble through the banded linear-solver tier.

A 1-D heat equation (method of lines, n=128 interior points, tridiagonal
Jacobian) solved for an ensemble of heterogeneous diffusivities in ONE
lockstep program.  The no-pivot band LU runs as one Triton kernel launch
per factorization or solve on a GPU (`ops/pallas_banded.py`) and as the
XLA loop elsewhere; the results agree to roundoff.

Reference analog: heat1d MOL class, reference crates/diffsol/src/
ode_solver/test_models/heat1d.rs (the banded tier's natural problem);
the ensemble axis is this framework's extension.

Run: python examples/heat1d_band_ensemble.py        (GPU if available)
     JAX_PLATFORMS=cpu python examples/heat1d_band_ensemble.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax

import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

import diffsol_tpu as dt
from diffsol_tpu.ops.banded import make_banded_solver

N = 128
H = 1.0 / (N + 1)


def rhs(t, y, p):
    d = p[0]
    left = jnp.concatenate([jnp.zeros_like(y[:1]), y[:-1]])
    right = jnp.concatenate([y[1:], jnp.zeros_like(y[:1])])
    return d * (left - 2.0 * y + right) / (H * H)


def init(t, p):
    x = (jnp.arange(N) + 1.0) * H
    return jnp.where(x < 0.5, 2.0 * x, 2.0 * (1.0 - x))


problem = (
    dt.OdeBuilder()
    .rhs(rhs)
    .init(init)
    .p([1.0])
    .rtol(1e-6)
    .atol(1e-8)
    .linear_solver(make_banded_solver(1, 1))  # tridiagonal: ml = mu = 1
    .build()
)

B = 256
t_eval = jnp.asarray([0.001, 0.01, 0.05, 0.1, 0.2])
diffusivities = jnp.linspace(0.5, 2.0, B)
params = diffusivities[:, None]

sol = dt.solve_dense_ensemble(
    dt.BdfSolver, problem, t_eval, params, mode="lockstep"
)
ys = np.asarray(sol.ys)  # (neval, B, n)
assert np.all(np.isfinite(ys))

# the d=1.0 member must track the analytic Fourier sine series
member = int(np.argmin(np.abs(np.asarray(diffusivities) - 1.0)))
x = (np.arange(N) + 1.0) * H
t64 = np.asarray(t_eval, np.float64)
u = np.zeros((len(t64), N))
for k in range(1, 200):
    m = 2 * k - 1
    # sin(m*pi/2) = (-1)^(k-1): the triangle wave's odd harmonics alternate
    u += (
        (-1.0) ** (k - 1)
        * np.sin(m * np.pi * x)[None, :]
        * np.exp(-(m * np.pi) ** 2 * float(diffusivities[member]) * t64)[:, None]
        / m**2
    )
u *= 8.0 / np.pi**2
err = np.max(np.abs(ys[:, member, :] - u))
print(f"backend={jax.default_backend()} B={B} n={N} "
      f"linear solver={problem.linear_solver.name}")
print(f"member d={float(diffusivities[member]):.3f}: max|err| vs analytic = {err:.2e}")
assert err < 1e-4, err

# faster diffusion decays the midpoint temperature faster, monotonically
mid = ys[-1, :, N // 2]
assert np.all(np.diff(mid) < 0), "midpoint decay not monotone in d"
print(f"u(x=0.5, t=0.2): d=0.5 -> {mid[0]:.4f}, d=2.0 -> {mid[-1]:.4f}")
print("ok")
