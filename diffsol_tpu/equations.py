"""ODE/DAE equation container.

Equivalent of the reference equations layer
(reference crates/diffsol/src/ode_equations/mod.rs:204-281 `OdeEquations` and
the closure-wrapping op layer, op/closure*.rs): a problem is a set of pure
JAX callables

    M(t, p) dy/dt = f(t, y, p),    y(t0) = y0(t0, p)

with optional root functions g_root(t, y, p) (events), an output g_out(t, y, p)
(optionally quadrature-integrated), and a reset R(t, y, p) applied after a root
event.  Where the reference needs hand-written Jacobian closures, Enzyme
autodiff (op/closure_autodiff.rs) or NaN-probe sparsity detection
(jacobian/mod.rs:16-114), this build derives everything from ``jax.jacfwd``
/ ``jax.jvp`` / ``jax.vjp`` -- automatic differentiation is the default, not a
feature.

All callables use the argument order ``(t, y, p)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class OdeEquations:
    """Static (hashable) bundle of problem callables and dimensions.

    Capability tiers of the reference (`OdeEquationsImplicit`, `...Sens`,
    `...Adjoint`, ode_equations/mod.rs:321-419) collapse here: every tier is
    available automatically through JAX AD.
    """

    rhs: Callable  # f(t, y, p) -> (n,)
    init: Callable  # y0(t, p) -> (n,)
    mass: Optional[Callable] = None  # M(t, p) -> (n, n); None => identity
    root: Optional[Callable] = None  # g(t, y, p) -> (nroots,)
    out: Optional[Callable] = None  # g(t, y, p) -> (nout,)
    reset: Optional[Callable] = None  # R(t, y, p) -> (n,)
    # Index-aware reset R(t, y, p, root_idx) -> (n,): the reference's
    # model-index protocol (diffsol-c ode_solver_type.rs:66
    # `set_model_index(root_idx)` before apply_reset; the DiffSL built-in
    # ``N``).  When present, drivers apply THIS at events, passing the
    # index of the root that fired.
    reset_n: Optional[Callable] = None
    # Optional user-supplied Jacobian in the linear-solver tier's matrix
    # representation; default is dense jax.jacfwd of rhs w.r.t. y.
    rhs_jac: Optional[Callable] = None  # (t, y, p) -> jac representation
    # Optional override for the mass action M(t,p) @ v (used by lockstep
    # ensembles where M is batched: (B,n,n) @ (B,n) needs an einsum).
    mass_mul_fn: Optional[Callable] = None  # (t, p, v) -> M v
    # Structurally DIAGONAL mass fast path: (t, p) -> (n,) diagonal values
    # ((n, B) under lockstep).  Set automatically by the builder when the
    # probed mass is diagonal (the common DAE case: reference heat2d,
    # foodweb, robertson all carry diag masses).  mass_mul becomes an
    # elementwise multiply and LU assembly never materializes (n, n[, B]) --
    # for a 400-state 32-member heat2d the dense einsum would be ~5e6 MACs
    # per residual evaluation.
    mass_diag_fn: Optional[Callable] = None  # (t, p) -> diag
    nstates: int = 0
    nout: int = 0
    nroots: int = 0
    nparams: int = 0

    # ---- derived operators (all pure; jit/vmap-safe) ----

    def f(self, t, y, p):
        return self.rhs(t, y, p)

    def jac(self, t, y, p):
        """Dense (or user-tier) Jacobian df/dy."""
        if self.rhs_jac is not None:
            return self.rhs_jac(t, y, p)
        return jax.jacfwd(self.rhs, argnums=1)(t, y, p)

    def jac_mul(self, t, y, p, v):
        """Jacobian-vector product (df/dy) @ v via forward AD."""
        return jax.jvp(lambda yy: self.rhs(t, yy, p), (y,), (v,))[1]

    def jac_transpose_mul(self, t, y, p, v):
        """(df/dy)^T @ v via reverse AD (adjoint equations)."""
        _, vjp = jax.vjp(lambda yy: self.rhs(t, yy, p), y)
        return vjp(v)[0]

    def time_partial(self, t, y, p):
        """dF/dt via forward AD: the op-layer surface of the reference's
        `NonLinearOpTimePartial` (op/nonlinear_op.rs:23-48).  The reset/root
        boundary corrections apply the same jvp-over-t to their own
        operators inline (augmented.py, adjoint.py)."""
        t = jnp.asarray(t)
        return jax.jvp(
            lambda tt: self.rhs(tt, y, p), (t,), (jnp.ones_like(t),)
        )[1]

    def sens_mul(self, t, y, p, v):
        """(df/dp) @ v via forward AD (forward sensitivities)."""
        return jax.jvp(lambda pp: self.rhs(t, y, pp), (p,), (v,))[1]

    def sens_transpose_mul(self, t, y, p, v):
        """(df/dp)^T @ v via reverse AD (adjoint gradient quadrature)."""
        _, vjp = jax.vjp(lambda pp: self.rhs(t, y, pp), p)
        return vjp(v)[0]

    def mass_matrix(self, t, p):
        if self.mass is None:
            return None
        return self.mass(t, p)

    def mass_repr(self, t, p):
        """Mass in the cheapest representation ``assemble`` understands:
        None (identity), :class:`~diffsol_tpu.ops.linsol.DiagMass`
        (structurally diagonal -- no dense materialization), or the dense
        matrix."""
        if self.mass is None:
            return None
        if self.mass_diag_fn is not None:
            from .ops.linsol import DiagMass

            return DiagMass(self.mass_diag_fn(t, p))
        return self.mass(t, p)

    def mass_mul(self, t, p, v):
        if self.mass is None:
            return v
        if self.mass_diag_fn is not None:
            return v * self.mass_diag_fn(t, p)
        if self.mass_mul_fn is not None:
            return self.mass_mul_fn(t, p, v)
        return self.mass(t, p) @ v

    def has_mass(self) -> bool:
        return self.mass is not None

    def __hash__(self):
        return hash(
            (
                self.rhs,
                self.init,
                self.mass,
                self.root,
                self.out,
                self.reset,
                self.reset_n,
                self.rhs_jac,
                self.mass_mul_fn,
                self.mass_diag_fn,
                self.nstates,
                self.nout,
                self.nroots,
                self.nparams,
            )
        )


def make_equations(
    rhs: Callable,
    init: Callable,
    params,
    t0=0.0,
    *,
    mass: Optional[Callable] = None,
    root: Optional[Callable] = None,
    out: Optional[Callable] = None,
    reset: Optional[Callable] = None,
    rhs_jac: Optional[Callable] = None,
    mass_diag: Optional[Callable] = None,
    reset_n: Optional[Callable] = None,
) -> OdeEquations:
    """Build an :class:`OdeEquations`, inferring dimensions with eval_shape."""
    params = jnp.asarray(params)
    t0 = jnp.asarray(t0, dtype=params.dtype if params.size else None)
    y_shape = jax.eval_shape(init, t0, params)
    nstates = int(y_shape.shape[0]) if y_shape.shape else 1
    y_dummy = jax.ShapeDtypeStruct(y_shape.shape, y_shape.dtype)
    nroots = 0
    if root is not None:
        r_shape = jax.eval_shape(root, t0, y_dummy, params)
        nroots = int(r_shape.shape[0]) if r_shape.shape else 1
    nout = 0
    if out is not None:
        o_shape = jax.eval_shape(out, t0, y_dummy, params)
        nout = int(o_shape.shape[0]) if o_shape.shape else 1
    nparams = int(params.shape[0]) if params.ndim else params.size
    return OdeEquations(
        rhs=rhs,
        init=init,
        mass=mass,
        root=root,
        out=out,
        reset=reset,
        reset_n=reset_n,
        rhs_jac=rhs_jac,
        mass_diag_fn=mass_diag,
        nstates=nstates,
        nout=nout,
        nroots=nroots,
        nparams=nparams,
    )
