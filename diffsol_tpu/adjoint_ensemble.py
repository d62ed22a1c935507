"""Differentiable ensembles: jax.grad through lockstep (and vmap) solves.

The reference's adjoint operates over its ``nbatch`` batched context
(reference crates/diffsol/src/ode_solver/adjoint.rs:13-159 with
crates/diffsol-la/src/context/mod.rs:20-51): every vector in the backward
pass carries the batch axis and the discrete output jumps apply per batch
member.  This module extends :mod:`diffsol_tpu.adjoint` to lockstep
ensemble problems:

* the forward pass records a batch-last step table (rows, n, B) -- the
  members share one step sequence (lockstep semantics), so ONE time grid
  serves every member's Hermite interpolant;
* the backward pass integrates the batched augmented adjoint system
  z = [lambda (n,B); g_p (np,B)] with the same lockstep BDF machinery
  (batch-last block LU, mean-then-max WRMS norms);
* output jumps, mass-transpose solves, the singular-mass DAE partition and
  the init-condition correction are the single-instance operators of
  :mod:`diffsol_tpu.adjoint` ``vmap``-ped over the member axis;
* gradients come out per member: (B, nparams).

This is a capability the reference does NOT have (its adjoint is
single-context; the batched context is used for forward solves), and the
one that makes ensemble *fitting* native: compose ``ys_of`` with any JAX
loss and optimizer and train 1k+ parameter sets in one compiled program.

Independent (per-member control flow) ensembles need no machinery at all:
``jax.vmap(make_differentiable_solve(problem, t_eval))`` batches the
custom_vjp (JAX batches fwd and bwd), giving each member its own adaptive
step sequence; :func:`make_differentiable_solve_ensemble` exposes this as
``mode="independent"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from .adjoint import (
    MAX_EVENTS,
    _boundary_schedule,
    _event_correction_core,
    _init_correction,
    _integrate_to,
    _make_jump,
    _make_reinit,
    forward_with_table,
    hermite_interp,
)
from .drivers import init_state_jit
from .ensemble import _lockstep_dense_spec, make_lockstep_problem
from .equations import OdeEquations
from .problem import OdeProblem


def _adjoint_problem_lockstep(base_problem: OdeProblem,
                              lockstep_problem: OdeProblem,
                              t_top, table, ct_g=None,
                              table_rows=None):
    """Batched time-reversed augmented adjoint problem in sigma = t_top - t.

    State z = (n + nparams, B) batch-last; member b solves

        M_b^T dlambda/dsigma = +J(x_b(t))^T lambda [+ u_y^T ct_g_b]
        dg_p/dsigma          = +f_p(x_b(t))^T lambda [+ u_p^T ct_g_b]

    (the lockstep lift of adjoint.py:_adjoint_problem; reference
    adjoint_equations.rs:330-460 over the nbatch context).  The batched
    rhs/jacobian are vmaps of the single-member operators with each
    member's own table slice (the time grid ts is SHARED -- lockstep).
    """
    eqn = base_problem.eqn  # single-member callables
    n = eqn.nstates
    nparams = eqn.nparams
    B = lockstep_problem.lockstep_nbatch
    dtype = base_problem.atol.dtype
    N = n + nparams
    out_fn = eqn.out if eqn.out is not None else (lambda tt, yy, pp: yy)

    if table is not None:
        ts_tab, ys_tab, dys_tab = table[0], table[1], table[2]

        def split(p_row):
            return p_row, None  # table comes in via vmap operands
    else:
        # bounded-memory mode: each member's segment Hermite table rides in
        # its params row after the real parameters (the single-instance
        # packing of adjoint._adjoint_problem, lifted per member)
        if table_rows is None:
            raise ValueError("need table or table_rows")
        R = table_rows

        def split(p_row):
            rp = p_row[:nparams]
            ts = p_row[nparams:nparams + R]
            off = nparams + R
            ys_m = p_row[off:off + R * n].reshape(R, n)
            dys_m = p_row[off + R * n:off + 2 * R * n].reshape(R, n)
            return rp, (ts, ys_m, dys_m)

    def member_rhs(sigma, z, p_row, ys_m, dys_m, ct_g_m):
        p, packed = split(p_row)
        t = t_top - sigma
        if packed is None:
            x = hermite_interp((ts_tab, ys_m, dys_m), t)
        else:
            x = hermite_interp(packed, t)
        lam = z[:n]
        _, vjp_y = jax.vjp(lambda yy: eqn.rhs(t, yy, p), x)
        _, vjp_p = jax.vjp(lambda pp: eqn.rhs(t, x, pp), p)
        dlam = vjp_y(lam)[0]
        dgp = vjp_p(lam)[0]
        if ct_g is not None:
            _, vjp_uy = jax.vjp(lambda yy: out_fn(t, yy, p), x)
            _, vjp_up = jax.vjp(lambda pp: out_fn(t, x, pp), p)
            dlam = dlam + vjp_uy(ct_g_m)[0]
            dgp = dgp + vjp_up(ct_g_m)[0]
        return jnp.concatenate([dlam, dgp])

    ct_dummy = jnp.zeros((B, 0), dtype) if ct_g is None else ct_g.T  # (B, nout)
    if table is not None:
        tab_axes = (2, 2)
        tab_args = lambda: (ys_tab, dys_tab)
    else:
        zero_tab = jnp.zeros((0, 0, B), dtype)
        tab_axes = (2, 2)
        tab_args = lambda: (zero_tab, zero_tab)

    def rhs(sigma, Z, Pb):
        ys_a, dys_a = tab_args()
        return jax.vmap(
            member_rhs, in_axes=(None, 1, 0) + tab_axes + (0,), out_axes=1
        )(sigma, Z, Pb, ys_a, dys_a, ct_dummy)

    def rhs_jac(sigma, Z, Pb):
        def member_jac(z, p_row, ys_m, dys_m, ct_g_m):
            return jax.jacfwd(
                lambda zz: member_rhs(sigma, zz, p_row, ys_m, dys_m, ct_g_m)
            )(z)

        ys_a, dys_a = tab_args()
        return jax.vmap(
            member_jac, in_axes=(1, 0) + tab_axes + (0,), out_axes=2
        )(Z, Pb, ys_a, dys_a, ct_dummy)

    def init(sigma, Pb):
        return jnp.zeros((N, B), dtype)

    adj_mass = None
    mass_mul_fn = None
    if eqn.mass is not None:
        def member_mass(sigma, p_row):
            p = split(p_row)[0]
            m_t = eqn.mass(t_top - sigma, p).T
            return jnp.eye(N, dtype=m_t.dtype).at[:n, :n].set(m_t)

        def adj_mass(sigma, Pb):  # (N, N, B) batch-last
            return jax.vmap(member_mass, in_axes=(None, 0), out_axes=2)(
                sigma, Pb
            )

        def mass_mul_fn(sigma, Pb, v):
            return jnp.einsum("ijb,...jb->...ib", adj_mass(sigma, Pb), v)

    adj_eqn = OdeEquations(
        rhs=rhs,
        init=init,
        mass=adj_mass,
        rhs_jac=rhs_jac,
        mass_mul_fn=mass_mul_fn,
        nstates=N,
        nout=0,
        nroots=0,
        nparams=nparams,
    )
    # gp-row tolerances follow the single-instance rule
    # (adjoint_equations.rs:580-581): param_atol * param_scales, else the
    # mean state atol
    if base_problem.param_atol is not None:
        gp_atol = base_problem.param_atol
        if base_problem.param_scales is not None:
            gp_atol = gp_atol * base_problem.param_scales
    else:
        gp_atol = jnp.full((nparams,), jnp.mean(base_problem.atol))
    atol = jnp.concatenate(
        [base_problem.atol, jnp.asarray(gp_atol, dtype)]
    )[:, None]  # (N, 1): broadcasts over the member lanes
    return dataclasses.replace(
        lockstep_problem,
        eqn=adj_eqn,
        atol=atol,
        t0=jnp.asarray(0.0, dtype),
        h0=jnp.asarray(0.0, dtype),
        integrate_out=False,
        linear_solver=_lockstep_dense_spec(B, N),
    )


def _make_event_correction_lockstep(base_problem, events, params_b, ct_g,
                                    out_fn):
    """Batched reset-event boundary correction: (lam, gp, slot) -> (lam, gp).

    The member-wise :func:`diffsol_tpu.adjoint._event_correction_core`
    vmapped over the member lanes.  Lockstep root semantics guarantee ONE
    shared event time t* and root index k per event (ensemble.py batched
    root protocol), so only the states/params/cotangents carry the member
    axis: lam/gp/y-/dy-/y+/dy+ map over axis 1 (lanes), params and ct_g
    over axis 0 (member rows).  Reference: apply_reset_with_adjoint over
    the nbatch context, adjoint.rs:106-148.
    """
    core = _event_correction_core(
        base_problem.eqn, base_problem.atol.dtype, out_fn, ct_g is not None
    )
    B = params_b.shape[0]
    dtype = base_problem.atol.dtype
    ct_b = jnp.zeros((B, 0), dtype) if ct_g is None else ct_g.T  # (B, nout)

    def correct(lam, gp_rows, slot):
        t_star = events["t"][slot]
        k = events["idx"][slot]

        def member(lam1, gp1, y_m, dy_m, y_p, dy_p, p, cg):
            return core(lam1, gp1, t_star, y_m, dy_m, y_p, dy_p, k, p, cg)

        return jax.vmap(
            member, in_axes=(1, 1, 1, 1, 1, 1, 0, 0), out_axes=(1, 1)
        )(
            lam, gp_rows,
            events["y_minus"][slot], events["dy_minus"][slot],
            events["y_plus"][slot], events["dy_plus"][slot],
            params_b, ct_b,
        )

    return correct


def backward_pass_lockstep(base_problem, lockstep_problem, solver_cls, table,
                           events, t_eval, ct_ys, params_b, max_steps,
                           ct_g=None):
    """Batched adjoint backward pass over all output times and reset events.

    ``ct_ys``: (neval, n, B) internal batch-last cotangents; ``ct_g``:
    optional (nout, B) quadrature cotangent.  ``events`` is the recorded
    reset-event dict from the lockstep forward pass (member axes on
    y/dy fields, ONE shared time/index per event).  Returns per-member
    gradients (B, nparams).
    """
    eqn = base_problem.eqn
    n = eqn.nstates
    dtype = base_problem.atol.dtype
    t_eval = jnp.asarray(t_eval, dtype)
    neval = t_eval.shape[0]
    t_top = t_eval[-1]
    t0 = base_problem.t0
    has_events = eqn.reset is not None and eqn.root is not None

    adj_problem = _adjoint_problem_lockstep(
        base_problem, lockstep_problem, t_top, table, ct_g=ct_g
    )
    solver = solver_cls(adj_problem)
    state = init_state_jit(solver, params_b)

    jump1 = _make_jump(base_problem)
    # lam (n,B) / gp (np,B) / v (n,B) / x (n,B) map over axis 1 (the member
    # lanes); params over axis 0 (member rows)
    jump_b = jax.vmap(jump1, in_axes=(1, 1, 1, None, 1, 0), out_axes=(1, 1))
    out_fn = eqn.out if eqn.out is not None else (lambda tt, yy, pp: yy)
    correct_b = _make_event_correction_lockstep(
        base_problem, events, params_b, ct_g, out_fn
    )
    reinit = _make_reinit(solver, adj_problem)
    bt, btype, bslot, order = _boundary_schedule(t_eval, events, dtype)
    max_ev = events["t"].shape[0]
    sigma_end = t_top - t0

    def apply_output_jump(state, slot):
        t = t_top - state.t
        x = hermite_interp(table, t)  # (n, B)
        lam, gp_rows = state.y[:n], state.y[n:]
        lam, gp_rows = jump_b(lam, gp_rows, ct_ys[slot], t, x, params_b)
        return reinit(
            state.replace(y=jnp.concatenate([lam, gp_rows])), params_b
        )

    def apply_event_correction(state, slot):
        lam, gp_rows = state.y[:n], state.y[n:]
        lam_new, gp_new = correct_b(lam, gp_rows, slot)
        return reinit(
            state.replace(y=jnp.concatenate([lam_new, gp_new])), params_b
        )

    def seg_body(i, state):
        j = order[i]
        t_b = bt[j]
        valid = jnp.isfinite(t_b)

        def process(state):
            state = _integrate_to(
                solver, state, t_top - t_b, params_b, max_steps
            )
            if has_events:
                return jax.lax.cond(
                    btype[j] == 0,
                    lambda s: apply_output_jump(s, bslot[j]),
                    lambda s: apply_event_correction(s, bslot[j]),
                    state,
                )
            return apply_output_jump(state, bslot[j])

        return jax.lax.cond(valid, process, lambda s: s, state)

    state = jax.lax.fori_loop(0, neval + max_ev, seg_body, state)
    state = _integrate_to(solver, state, sigma_end, params_b, max_steps)
    lam0, gp = state.y[:n], state.y[n:]
    corr = jax.vmap(
        lambda p, l, g: _init_correction(base_problem, p, l, g),
        in_axes=(0, 1, 1),
    )
    return corr(params_b, lam0, gp)  # (B, nparams)


def backward_pass_bounded_lockstep(base_problem, lockstep_problem,
                                   solver_cls, fwd_solver, ckpts, events,
                                   t_eval, ct_ys, params_b, max_steps,
                                   interval, ct_g=None):
    """Bounded-memory batched backward pass (the lockstep lift of
    adjoint.backward_pass_bounded): walk the sparse full-state checkpoints
    top-down, re-solve each segment with the LOCKSTEP forward solver to
    rebuild its (R, n, B) Hermite table, and ride each member's table
    slice into the adjoint solver inside its params row.  Reset events are
    re-found by the segment re-solve (double table knots) and their
    boundary corrections fire inside the segment that contains them,
    exactly as in the single-instance bounded pass."""
    from .adjoint import _record_segment

    eqn = base_problem.eqn
    n = eqn.nstates
    nparams = eqn.nparams
    dtype = base_problem.atol.dtype
    t_eval = jnp.asarray(t_eval, dtype)
    neval = t_eval.shape[0]
    t_top = t_eval[-1]
    B = params_b.shape[0]
    ck_ts, ck_states, n_ck = ckpts
    n_slots = ck_ts.shape[0]
    has_events = eqn.reset is not None and eqn.root is not None
    max_ev = events["t"].shape[0]
    seg_steps = interval + 4  # margin for the tstop-truncated last step
    R = seg_steps + 2 * max_ev + 1

    adj_problem = _adjoint_problem_lockstep(
        base_problem, lockstep_problem, t_top, None, ct_g=ct_g,
        table_rows=R,
    )
    solver = solver_cls(adj_problem)

    jump1 = _make_jump(base_problem)
    jump_b = jax.vmap(jump1, in_axes=(1, 1, 1, None, 1, 0), out_axes=(1, 1))
    out_fn = eqn.out if eqn.out is not None else (lambda tt, yy, pp: yy)
    correct_b = _make_event_correction_lockstep(
        base_problem, events, params_b, ct_g, out_fn
    )
    reinit = _make_reinit(solver, adj_problem)
    bt, btype, bslot, order = _boundary_schedule(t_eval, events, dtype)

    def seg_params(s):
        st = jax.tree_util.tree_map(lambda b: b[s], ck_states)
        t_end = ck_ts[s + 1]
        ts_l, ys_l, dys_l = _record_segment(
            fwd_solver, st, t_end, params_b, seg_steps, max_events=max_ev
        )  # ts (R,), ys/dys (R, n, B)
        pa = jnp.concatenate(
            [
                params_b,
                jnp.broadcast_to(ts_l, (B, R)),
                jnp.moveaxis(ys_l, -1, 0).reshape(B, R * n),
                jnp.moveaxis(dys_l, -1, 0).reshape(B, R * n),
            ],
            axis=1,
        )
        return pa, (ts_l, ys_l, dys_l)

    top = seg_params(n_ck - 2)
    state = init_state_jit(solver, top[0])

    def apply_output_jump(state, slot, pa, tab):
        t = t_top - state.t
        x = hermite_interp(tab, t)  # (n, B)
        lam, gp_rows = state.y[:n], state.y[n:]
        lam, gp_rows = jump_b(lam, gp_rows, ct_ys[slot], t, x, params_b)
        return reinit(state.replace(y=jnp.concatenate([lam, gp_rows])), pa)

    def apply_event_correction(state, slot, pa):
        lam, gp_rows = state.y[:n], state.y[n:]
        lam_new, gp_new = correct_b(lam, gp_rows, slot)
        return reinit(
            state.replace(y=jnp.concatenate([lam_new, gp_new])), pa
        )

    def seg_body(i, state):
        s = n_slots - 2 - i
        valid = (s >= 0) & (s <= n_ck - 2)

        def process(state):
            is_top = s == n_ck - 2
            pa, tab = jax.lax.cond(is_top, lambda: top, lambda: seg_params(s))
            is_bot = s == 0
            upper = jnp.where(is_top, jnp.inf, ck_ts[s + 1])
            lower = jnp.where(is_bot, -jnp.inf, ck_ts[s])

            def bnd_body(jj, state):
                j = order[jj]
                t_b = bt[j]
                inside = jnp.isfinite(t_b) & (t_b > lower) & (t_b <= upper)

                def apply(state):
                    state = _integrate_to(
                        solver, state, t_top - t_b, pa, max_steps
                    )
                    if has_events:
                        return jax.lax.cond(
                            btype[j] == 0,
                            lambda st: apply_output_jump(
                                st, bslot[j], pa, tab
                            ),
                            lambda st: apply_event_correction(
                                st, bslot[j], pa
                            ),
                            state,
                        )
                    return apply_output_jump(state, bslot[j], pa, tab)

                return jax.lax.cond(inside, apply, lambda st: st, state)

            state = jax.lax.fori_loop(0, neval + max_ev, bnd_body, state)
            return _integrate_to(
                solver, state, t_top - ck_ts[s], pa, max_steps
            )

        return jax.lax.cond(valid, process, lambda st: st, state)

    state = jax.lax.fori_loop(0, n_slots - 1, seg_body, state)
    lam0, gp = state.y[:n], state.y[n:]
    corr = jax.vmap(
        lambda p, l, g: _init_correction(base_problem, p, l, g),
        in_axes=(0, 1, 1),
    )
    return corr(params_b, lam0, gp)  # (B, nparams)


def make_differentiable_solve_ensemble(
    problem: OdeProblem,
    t_eval,
    nbatch: int,
    mode: str = "lockstep",
    solver_cls=None,
    max_steps: int = 16_384,
    bwd_solver_cls=None,
    bwd_max_steps: Optional[int] = None,
    checkpoint_interval: Optional[int] = None,
):
    """Return ``ys_of(params_b) -> (neval, B, n)`` differentiable per member.

    ``params_b`` is (B, nparams); ``jax.grad``/``jax.vjp`` of any scalar of
    the output produce per-member gradients (B, nparams) via ONE batched
    adjoint solve (lockstep mode) -- the whole fit loop stays on device.

    ``mode="independent"`` instead vmaps the single-instance differentiable
    solve: each member gets its own adaptive step sequence (and its own
    backward-pass step sequence), at the cost of all members stepping until
    the slowest finishes.  Prefer lockstep for homogeneous ensembles, where
    the shared table also makes the backward pass cheapest.
    """
    from .solvers.bdf import BdfSolver

    solver_cls = solver_cls or BdfSolver
    bwd_solver_cls = bwd_solver_cls or solver_cls
    bwd_max_steps = bwd_max_steps or max_steps
    t_eval = jnp.asarray(t_eval)

    if mode == "independent":
        from .adjoint import make_differentiable_solve

        one = make_differentiable_solve(
            problem, t_eval, solver_cls=solver_cls, max_steps=max_steps,
            bwd_solver_cls=bwd_solver_cls, bwd_max_steps=bwd_max_steps,
        )

        def ys_of(params_b):
            return jnp.moveaxis(jax.vmap(one)(params_b), 0, 1)

        return ys_of
    if mode != "lockstep":
        raise ValueError(f"unknown ensemble mode: {mode!r}")

    lp = make_lockstep_problem(problem, nbatch)
    solver = solver_cls(lp)

    if checkpoint_interval is None:
        @jax.custom_vjp
        def ys_of(params_b):
            ys, _g, _table, _ev, _st = forward_with_table(
                solver, t_eval, params_b, max_steps
            )
            return jnp.moveaxis(ys, -1, 1)  # (neval, B, n)

        def fwd(params_b):
            ys, _g, table, ev, _st = forward_with_table(
                solver, t_eval, params_b, max_steps
            )
            return jnp.moveaxis(ys, -1, 1), (params_b, table, ev)

        def bwd(res, ct):
            params_b, table, ev = res
            ct_int = jnp.moveaxis(ct, 1, -1)  # (neval, n, B)
            grad_b = backward_pass_lockstep(
                problem, lp, bwd_solver_cls, table, ev, t_eval, ct_int,
                params_b, bwd_max_steps,
            )
            return (grad_b,)
    else:
        from .adjoint import forward_with_checkpoints

        K = int(checkpoint_interval)

        @jax.custom_vjp
        def ys_of(params_b):
            ys, _g, _ck, _ev, _st = forward_with_checkpoints(
                solver, t_eval, params_b, max_steps, K
            )
            return jnp.moveaxis(ys, -1, 1)

        def fwd(params_b):
            ys, _g, ckpts, ev, _st = forward_with_checkpoints(
                solver, t_eval, params_b, max_steps, K
            )
            return jnp.moveaxis(ys, -1, 1), (params_b, ckpts, ev)

        def bwd(res, ct):
            params_b, ckpts, ev = res
            ct_int = jnp.moveaxis(ct, 1, -1)
            grad_b = backward_pass_bounded_lockstep(
                problem, lp, bwd_solver_cls, solver, ckpts, ev, t_eval,
                ct_int, params_b, bwd_max_steps, K,
            )
            return (grad_b,)

    ys_of.defvjp(fwd, bwd)
    return ys_of


def make_differentiable_quadrature_ensemble(
    problem: OdeProblem,
    t_final,
    nbatch: int,
    solver_cls=None,
    max_steps: int = 16_384,
    bwd_solver_cls=None,
    bwd_max_steps: Optional[int] = None,
    checkpoint_interval: Optional[int] = None,
):
    """Return ``g_of(params_b) -> (B, nout)``: per-member quadrature outputs
    G_b = int u(t, y_b, p_b) dt, reverse-differentiable through the batched
    continuous adjoint with the u_y^T forcing (the lockstep lift of
    :func:`diffsol_tpu.adjoint.make_differentiable_quadrature`)."""
    from .solvers.bdf import BdfSolver

    if not problem.integrate_out:
        raise ValueError(
            "make_differentiable_quadrature_ensemble needs a problem built "
            "with .integrate_out()"
        )
    solver_cls = solver_cls or BdfSolver
    bwd_solver_cls = bwd_solver_cls or solver_cls
    bwd_max_steps = bwd_max_steps or max_steps
    t_eval = jnp.asarray([t_final])
    lp = make_lockstep_problem(problem, nbatch)
    solver = solver_cls(lp)
    n = problem.eqn.nstates

    if checkpoint_interval is None:
        @jax.custom_vjp
        def g_of(params_b):
            _ys, g, _table, _ev, _st = forward_with_table(
                solver, t_eval, params_b, max_steps
            )
            return g.T  # (B, nout)

        def fwd(params_b):
            _ys, g, table, ev, _st = forward_with_table(
                solver, t_eval, params_b, max_steps
            )
            return g.T, (params_b, table, ev)

        def bwd(res, ct_g):
            params_b, table, ev = res
            B = params_b.shape[0]
            zeros_ct = jnp.zeros((1, n, B), problem.atol.dtype)
            grad_b = backward_pass_lockstep(
                problem, lp, bwd_solver_cls, table, ev, t_eval, zeros_ct,
                params_b, bwd_max_steps, ct_g=ct_g.T,
            )
            return (grad_b,)
    else:
        from .adjoint import forward_with_checkpoints

        K = int(checkpoint_interval)

        @jax.custom_vjp
        def g_of(params_b):
            _ys, g, _ck, _ev, _st = forward_with_checkpoints(
                solver, t_eval, params_b, max_steps, K
            )
            return g.T

        def fwd(params_b):
            _ys, g, ckpts, ev, _st = forward_with_checkpoints(
                solver, t_eval, params_b, max_steps, K
            )
            return g.T, (params_b, ckpts, ev)

        def bwd(res, ct_g):
            params_b, ckpts, ev = res
            B = params_b.shape[0]
            zeros_ct = jnp.zeros((1, n, B), problem.atol.dtype)
            grad_b = backward_pass_bounded_lockstep(
                problem, lp, bwd_solver_cls, solver, ckpts, ev, t_eval,
                zeros_ct, params_b, bwd_max_steps, K, ct_g=ct_g.T,
            )
            return (grad_b,)

    g_of.defvjp(fwd, bwd)
    return g_of
