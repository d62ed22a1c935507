"""Ensemble solving: the data-parallel axis of the framework.

The reference's parallelism axis is batched ensemble solving on one GPU via
the ``nbatch`` execution context (reference crates/diffsol-la/src/context/
mod.rs:20-51, vector/cuda.rs:34-65 2D kernel grids, cuda/lu.rs per-batch LU;
error norms reduce MAX across batch members so every member shares one
adaptive step, vector/mod.rs tests:756-775).  This package provides BOTH
semantics, each sharded over a ``jax.sharding.Mesh``:

* **lockstep** (reference parity): ONE solve whose state "vector" is the
  2-D array (nstates, nbatch) -- the ensemble axis last, so it is the
  contiguous one.  All solver arithmetic is shape agnostic, the WRMS
  norms reduce mean-over-states then max-over-members
  (:mod:`diffsol_tpu.norms`), and the block LU runs batch-LAST on
  (n, n, nbatch) Jacobian stacks: every per-member scalar of the
  elimination is then one contiguous vector across the ensemble.
* **independent**: ``vmap`` of the whole stepper -- JAX's while-loop
  batching gives each member its own adaptive control flow (finished
  members are masked).  More robust for heterogeneous/event-driven
  ensembles, at the cost of all members stepping until the slowest
  finishes.

Sharding: both modes shard the batch axis across the mesh with
``NamedSharding``; member solves are embarrassingly parallel so the only
collective in lockstep mode is the error-norm max (XLA inserts it from the
sharded reduce).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .drivers import init_state_jit, solve_dense
from .equations import OdeEquations
from .ops import smalllu
from .ops.linsol import LinearSolverSpec
from .problem import OdeProblem


def _lockstep_dense_spec(nbatch: int, n: int) -> LinearSolverSpec:
    """Batch-last block-dense LU: matrices (n, n, nbatch), RHS (n, nbatch)."""

    def assemble(mass, jac, c):
        from .ops.linsol import DiagMass

        if mass is None:
            m = jnp.eye(n, dtype=jac.dtype)[:, :, None]
        elif isinstance(mass, DiagMass):
            # diag (n, B): D[i, j, b] = (i == j) * d[j, b]
            m = jnp.eye(n, dtype=jac.dtype)[:, :, None] * mass.d[None, :, :]
        else:
            m = mass
        return m - c * jac

    def factor(a):
        return smalllu.lu_factor_batch_last(a)

    def solve(factors, b):
        if b.ndim == 3:  # augmented rows (naug, n, B): one factorization
            return jax.vmap(
                lambda v: smalllu.lu_solve_batch_last(factors, v)
            )(b)
        return smalllu.lu_solve_batch_last(factors, b)

    def placeholder(_n, dtype):
        eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype)[:, :, None], (n, n, nbatch))
        return smalllu.lu_factor_batch_last(eye)

    return LinearSolverSpec(
        name=f"lockstep_dense({nbatch})",
        assemble=assemble,
        factor=factor,
        solve=solve,
        placeholder_factors=placeholder,
        meta=(nbatch,),
    )


# NOTE: the banded tier needs no lockstep wrapper -- its kernels accept
# batch-LAST (nbands, n, B) band arrays natively (ops/banded.py), matching
# the lockstep state layout (n, B).


def make_lockstep_problem(problem: OdeProblem, nbatch: int) -> OdeProblem:
    """Lift a problem to 2-D (nstates, nbatch) lockstep form (reference
    `nbatch` context).  params gain a leading (nbatch,) axis.

    Root functions follow the reference's batched semantics
    (vector/cuda.rs root_finding, tests vector/mod.rs:835-852): every
    member must agree on the sign-change pattern; the event fires at ONE
    shared root time (batch 0's polished crossing).  Disagreement is a
    typed failure (errors.ROOT_BATCH_INCONSISTENT; the reference panics) --
    use the independent (vmap) mode for event-heterogeneous ensembles."""
    eqn = problem.eqn
    n = eqn.nstates
    nout = eqn.nout
    banded = problem.linear_solver.name.startswith("banded")
    blockdiag = problem.linear_solver.name.startswith("blockdiag")
    krylov = problem.linear_solver.name.startswith("krylov")

    def over_members(f):
        # member function (t, (n,), (np,)) -> vectorized (t, (n,B), (B,np))
        return jax.vmap(f, in_axes=(None, 1, 0), out_axes=1)

    b_rhs = over_members(eqn.rhs)
    b_reset = None if eqn.reset is None else over_members(eqn.reset)
    b_out = None if eqn.out is None else over_members(eqn.out)
    b_root = None if eqn.root is None else over_members(eqn.root)

    def b_init(t, pb):
        return jax.vmap(eqn.init, in_axes=(None, 0), out_axes=1)(t, pb)  # (n, B)

    if krylov:
        # matrix-free tier: the Jacobian "representation" stays the frozen
        # linearization point, now batch-last ((n,B) state, (B,np) params)
        per_member_jac = None

        def b_jac(t, Y, pb):
            return (t, Y, pb)

        b_jac.jvp_probes = 0
    elif eqn.rhs_jac is not None:
        per_member_jac = eqn.rhs_jac
    else:
        per_member_jac = lambda t, y, p: jax.jacfwd(eqn.rhs, argnums=1)(t, y, p)

    if krylov:
        pass
    elif blockdiag:
        # fuse the block axis and the member axis: (nb, nb, K*B) batch-last
        from .ops.blockdiag import make_blockdiag_jac_lockstep

        nb_, K_ = problem.linear_solver.meta[:2]
        b_jac = make_blockdiag_jac_lockstep(per_member_jac, nb_, K_)
    else:
        def b_jac(t, Y, pb):
            # batch-last: (nbands, n, B) band arrays or (n, n, B) dense blocks
            return jax.vmap(per_member_jac, in_axes=(None, 1, 0), out_axes=2)(
                t, Y, pb
            )

        if hasattr(per_member_jac, "jvp_probes"):
            b_jac.jvp_probes = per_member_jac.jvp_probes

    b_mass = None
    mass_mul_fn = None
    b_mass_diag = None
    if eqn.mass is not None:
        def b_mass(t, pb):  # (n, n, B)
            return jax.vmap(eqn.mass, in_axes=(None, 0), out_axes=2)(t, pb)

        if eqn.mass_diag_fn is not None:
            # diagonal fast path: (n, B) values; mass_mul is elementwise
            def b_mass_diag(t, pb):
                return jax.vmap(
                    eqn.mass_diag_fn, in_axes=(None, 0), out_axes=1
                )(t, pb)
        else:
            def mass_mul_fn(t, pb, v):
                return jnp.einsum("ijb,...jb->...ib", b_mass(t, pb), v)

    new_eqn = OdeEquations(
        rhs=b_rhs,
        init=b_init,
        mass=b_mass,
        root=b_root,
        out=b_out,
        reset=b_reset,
        rhs_jac=b_jac,
        mass_mul_fn=mass_mul_fn,
        mass_diag_fn=b_mass_diag,
        nstates=n,
        nout=nout,
        nroots=eqn.nroots,
        nparams=eqn.nparams,
    )
    params_b = jnp.broadcast_to(problem.params, (nbatch,) + problem.params.shape)
    atol_b = problem.atol[:, None]  # broadcasts over the member lanes
    out_atol_b = None if problem.out_atol is None else problem.out_atol[:, None]
    sens_atol_b = (
        None if problem.sens_atol is None else jnp.asarray(problem.sens_atol)[:, None]
    )
    if banded:
        # band kernels accept batch-LAST (nbands, n, B) arrays natively
        spec = problem.linear_solver
    elif blockdiag:
        from .ops.blockdiag import make_blockdiag_solver_lockstep

        nb_, K_, perm = problem.linear_solver.meta[:3]
        spec = make_blockdiag_solver_lockstep(perm, nb_, K_, n, nbatch)
    elif krylov:
        from .ops.krylov import make_krylov_solver_lockstep

        gmres_tol, restart, maxiter, precond = problem.linear_solver.meta[:4]
        member_jac_fn = (
            problem.linear_solver.meta[4]
            if len(problem.linear_solver.meta) > 4
            else None
        )
        spec = make_krylov_solver_lockstep(
            b_rhs,
            nbatch,
            gmres_tol=gmres_tol,
            restart=restart,
            maxiter=maxiter,
            precond="none" if precond == "none" else "lu32",
            member_jac_fn=member_jac_fn,
        )
    else:
        spec = _lockstep_dense_spec(nbatch, n)
    return dataclasses.replace(
        problem,
        eqn=new_eqn,
        params=params_b,
        atol=atol_b,
        out_atol=out_atol_b,
        sens_rtol=problem.sens_rtol,
        sens_atol=sens_atol_b,
        lockstep_nbatch=nbatch,
        linear_solver=spec,
    )


def solve_dense_ensemble(
    make_solver,
    problem: OdeProblem,
    t_eval,
    params_batch,
    mode: str = "lockstep",
    mesh: Optional[Mesh] = None,
    axis: str = "dp",
    max_steps: int = 100_000,
):
    """Solve an ensemble over ``params_batch`` (B, nparams).

    ``make_solver`` is a problem -> solver factory (e.g. ``BdfSolver``).
    With a ``mesh``, the batch axis is sharded over ``mesh[axis]``.
    Returns a :class:`diffsol_tpu.drivers.Solution` whose ``ys`` is
    (neval, B, nstates).

    Modes: ``lockstep`` (reference nbatch-context parity: one shared
    adaptive step sequence) and ``independent`` (vmap, per-member
    adaptivity).
    """
    params_batch = jnp.asarray(params_batch)
    nbatch = params_batch.shape[0]

    if mode == "lockstep":
        lp = make_lockstep_problem(problem, nbatch)
        solver = make_solver(lp)

        def run(pb):
            state = init_state_jit(solver, pb)
            sol = solve_dense(
                solver, t_eval, params=pb, state=state, max_steps=max_steps
            )
            ys = jnp.moveaxis(sol.ys, -1, 1)  # (neval, B, n)
            gs = sol.gs
            if gs is not None:  # out(t, y) columns, or the quadrature of y
                gs = jnp.moveaxis(gs, -1, 1)  # (neval, B, nout or n)
            return sol.replace(ys=ys, gs=gs, tier="lockstep")

        if mesh is not None:
            shard = NamedSharding(mesh, P(axis))
            params_batch = jax.device_put(params_batch, shard)
            run = jax.jit(run, in_shardings=(shard,))
        return run(params_batch)

    if mode == "independent":
        solver = make_solver(problem)

        def run_one(p):
            state = init_state_jit(solver, p)
            return solve_dense(
                solver, t_eval, params=p, state=state, max_steps=max_steps
            )

        def run(pb):
            sol = jax.vmap(run_one)(pb)
            return sol.replace(
                ys=jnp.moveaxis(sol.ys, 0, 1), tier="independent"
            )

        if mesh is not None:
            shard = NamedSharding(mesh, P(axis))
            params_batch = jax.device_put(params_batch, shard)
            run = jax.jit(run, in_shardings=(shard,))
        return run(params_batch)

    raise ValueError(
        f"unknown ensemble mode: {mode!r} (valid modes: 'lockstep', "
        "'independent')"
    )
