"""Linear-solver tiers.

The reference offers LU backends behind a ``LinearSolver`` trait
(set_sparsity -> set_linearisation -> solve_in_place; reference
crates/diffsol-la/src/linear_solver/mod.rs:19): dense LU (nalgebra/faer/
cuSOLVER) and sparse LU (faer sparse, KLU).  Here the equivalents are

* ``dense``  -- LU with partial pivoting via XLA (``jax.scipy.linalg``),
  batched for ensembles with ``vmap``;
* ``banded`` -- no-pivot banded LU (see :mod:`diffsol_tpu.ops.banded`) for
  method-of-lines Jacobians, replacing KLU's role.

A tier is a static :class:`LinearSolverSpec` of pure functions so solver
loops can carry factorizations as fixed-shape pytrees.  The operator solved
by the implicit steppers is ``A = M - c*J`` (BDF: c = h*alpha_k, reference
op/bdf.rs:259-270; SDIRK: c = h*gamma, op/sdirk.rs:248-263).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from . import smalllu


class DiagMass(NamedTuple):
    """Diagonal-mass representation passed to ``assemble`` when the
    equations carry a structurally diagonal mass (eqn.mass_diag_fn): the
    (n,) / lockstep (n, B) diagonal values -- LU assembly never builds the
    dense (n, n[, B]) matrix."""

    d: jax.Array


@dataclass(frozen=True)
class LinearSolverSpec:
    """Static vtable for one linear-solver tier.

    ``assemble(mass, jac, c)`` builds the iteration matrix ``M - c*J`` in the
    tier's matrix representation (``mass=None`` means identity);
    ``factor`` / ``solve`` are the usual two-phase LU interface and
    ``placeholder_factors(n, dtype)`` builds a dummy factorization pytree of
    the right shapes for initializing while-loop carries.
    """

    name: str
    assemble: Callable[[Any, Any, Any], Any]
    factor: Callable[[Any], Any]
    solve: Callable[[Any, Any], Any]
    placeholder_factors: Callable[[int, Any], Any]
    meta: tuple = ()  # tier parameters, e.g. (ml, mu) for banded


def _dense_assemble(mass, jac, c):
    n = jac.shape[-1]
    if mass is None:
        m = jnp.eye(n, dtype=jac.dtype)
    elif isinstance(mass, DiagMass):
        m = jnp.eye(n, dtype=jac.dtype) * mass.d
    else:
        m = mass
    return m - c * jac


def _dense_factor(a):
    # unrolled jnp LU for small n: compiles to straight-line batched code
    if a.shape[-1] <= smalllu.MAX_UNROLL_N:
        return smalllu.lu_factor(a)
    return jsl.lu_factor(a)


def _dense_solve(factors, b):
    if factors[0].shape[-1] <= smalllu.MAX_UNROLL_N:
        return smalllu.lu_solve(factors, b)
    return jsl.lu_solve(factors, b)


def _dense_placeholder(n, dtype):
    return (jnp.eye(n, dtype=dtype), jnp.arange(n, dtype=jnp.int32))


DENSE = LinearSolverSpec(
    name="dense",
    assemble=_dense_assemble,
    factor=_dense_factor,
    solve=_dense_solve,
    placeholder_factors=_dense_placeholder,
)


def _dense_f32_factor(a):
    a32 = a.astype(jnp.float32)
    if a.shape[-1] <= smalllu.MAX_UNROLL_N:
        return smalllu.lu_factor(a32)
    return jsl.lu_factor(a32)


def _dense_f32_solve(factors, b):
    if factors[0].shape[-1] <= smalllu.MAX_UNROLL_N:
        x = smalllu.lu_solve(factors, b.astype(jnp.float32))
    else:
        x = jsl.lu_solve(factors, b.astype(jnp.float32))
    return x.astype(b.dtype)


# Mixed-precision tier: factorize and solve the Newton iteration matrix in
# f32 while the residuals/error tests stay in the problem dtype.  The LU is
# only a preconditioner for the Newton iteration, whose convergence control
# (ops/newton.py) measures the true-dtype update -- accuracy is governed by
# the f64 residual, speed by the f32 factorization: a slightly slower
# Newton convergence rate for cheaper linear algebra.
DENSE_F32 = LinearSolverSpec(
    name="dense_f32",
    assemble=_dense_assemble,
    factor=_dense_f32_factor,
    solve=_dense_f32_solve,
    placeholder_factors=lambda n, dtype: _dense_placeholder(n, jnp.float32),
)


def get_solver(spec) -> LinearSolverSpec:
    """Resolve a tier name or spec into a :class:`LinearSolverSpec`."""
    if isinstance(spec, LinearSolverSpec):
        return spec
    if spec in (None, "dense"):
        return DENSE
    if spec == "dense_f32":
        return DENSE_F32
    if isinstance(spec, str) and spec.startswith("banded"):
        raise ValueError("use diffsol_tpu.ops.banded.make_banded_solver(ml, mu)")
    raise ValueError(f"unknown linear solver: {spec!r}")
