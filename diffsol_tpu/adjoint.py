"""Adjoint sensitivities: checkpointed backward pass + jax.grad support.

Reference semantics (reference crates/diffsol/src/ode_solver/adjoint.rs:13-260
`solve_adjoint_backwards_pass`, adjoint_equations.rs, checkpointing.rs): after
a forward solve, the adjoint system

    lambda' = -J(x(t), t)^T lambda,      lambda(T) = 0,
    discrete jumps  lambda += dG/dy_i    at each output time t_i,
    gradient        dG/dp = int lambda^T f_p dt + lambda(t0)^T dy0/dp

is integrated BACKWARD, interpolating the forward trajectory x(t) from
checkpoints.  Two storage modes are provided, mirroring the reference's
Checkpointing vs NoCheckpointingSolver split (checkpointing.rs:91-250,
no_checkpointing_solver.rs):

* **dense table** (default): (t, y, dy) at EVERY accepted forward step in
  fixed-size buffers, Hermite-interpolated directly -- recompute-free,
  memory O(steps * n), the right trade on HBM-rich accelerators.
* **bounded memory** (``checkpoint_interval=K``): a FULL solver-state
  checkpoint every K accepted steps; during the backward pass each segment
  is re-solved forward from its checkpoint to rebuild a K-row local table
  (the reference's segment re-solve + HermiteInterpolator,
  checkpointing.rs:91-119, method.rs:620-705).  Memory O(segments * state
  + K * n) -- for long horizons / large n where the dense table exceeds HBM.

The backward integration reuses the BDF solver on a time-reversed augmented
system z = [lambda, g_p] (sigma = T - t), one solve segment per output
interval, with the jump applied between segments (solver state is marked
modified, restarting at order 1 -- exactly the reference's behavior at
discrete jumps).

:func:`make_differentiable_solve` wraps all of this in a ``jax.custom_vjp``,
so ``jax.grad`` of any scalar function of the solution works -- the JAX-native
replacement for the reference's `AdjointOdeSolverMethod` API (and something
the reference cannot do: compose with the rest of a JAX program).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from . import errors
from .precision import highest_precision
from .drivers import init_state_jit
from .equations import OdeEquations, make_equations
from .problem import OdeProblem


# --------------------------------------------------------------------------
# forward pass with step-table recording
# --------------------------------------------------------------------------


MAX_EVENTS = 32  # default static capacity of the reset-event record


def forward_with_table(solver, t_eval, params, max_steps: int,
                       max_events: int = MAX_EVENTS):
    """solve_dense + record (t, y, dy) at every accepted step.

    Returns (ys, g, table, events).  table = (ts_tab, ys_tab, dys_tab,
    n_valid) is the dense-storage analog of the reference's
    CheckpointingRecorder (method.rs:620-705).  If the problem has
    root+reset events, the solve follows the full reset protocol and
    ``events`` records up to MAX_EVENTS boundaries
    (t*, y-, dy-, y+, dy+, root_idx, count) for the backward-pass
    corrections (reference checkpoint-path splitting at resets,
    checkpointing.rs:172-250); the step table gets TWO knots at each event
    so the Hermite interpolant never smears the discontinuity.

    Overflowing the ``max_events`` record is a TYPED FAILURE
    (errors.EVENT_CAPACITY_EXCEEDED): a dropped event would make the
    backward pass silently skip its boundary correction, so the solve
    fails loudly instead.
    """
    from .drivers import _apply_reset, _pin_to

    p = solver.problem
    has_reset = p.eqn.root is not None and p.eqn.reset is not None
    max_ev = max_events if has_reset else 0
    state = init_state_jit(solver, params)
    t_eval = jnp.asarray(t_eval, state.t.dtype)
    dtype = state.y.dtype
    neval = t_eval.shape[0]
    # yshape is (n,) for single solves, (n, B) for lockstep ensembles --
    # the table simply gains the member axis (batch-LAST, matching the
    # lockstep state layout)
    yshape = state.y.shape
    final_time = t_eval[-1]
    state = solver.set_stop_time(state, final_time)

    nrows = max_steps + 2 * max_ev + 1
    ts_tab = jnp.full((nrows,), jnp.inf, dtype)
    ys_tab = jnp.zeros((nrows,) + yshape, dtype)
    dys_tab = jnp.zeros((nrows,) + yshape, dtype)
    ts_tab = ts_tab.at[0].set(state.t)
    ys_tab = ys_tab.at[0].set(state.y)
    dys_tab = dys_tab.at[0].set(state.dy)
    ys = jnp.zeros((neval,) + yshape, dtype)
    ev = _empty_events(max_ev, yshape, dtype)

    def cond(c):
        (_s, _ys, _tt, _yt, _dt, _ev, k, done, _w) = c
        return (~done) & (k < max_steps)

    def body(c):
        (state, ys, ts_tab, ys_tab, dys_tab, ev, k, _done, written_to) = c
        new = solver.step(state, params)
        status = new.status
        fatal = status < 0
        is_tstop = status == errors.TSTOP_REACHED
        is_root = has_reset & (status == errors.ROOT_FOUND)
        t_upper = jnp.where(is_root, new.root_t, new.t)
        t_upper = jnp.where(is_tstop, jnp.maximum(new.t, final_time), t_upper)
        t_upper = jnp.where(fatal, written_to, t_upper)
        mask = (t_eval <= t_upper) & (t_eval > written_to)
        y_interp = jax.vmap(lambda tt: solver.interpolate(new, tt))(t_eval)
        ys = jnp.where(mask.reshape((-1,) + (1,) * len(yshape)), y_interp, ys)
        # record the accepted step knot (pin-backs overwrite it below)
        row = 2 * ev["count"] + k + 1
        write = lambda tab, val: jnp.where(fatal, tab, tab.at[row].set(val))

        if has_reset:
            def on_root(args):
                new, ev, ts_tab, ys_tab, dys_tab = args
                pinned = _pin_to(solver, new, new.root_t)
                after = _apply_reset(solver, pinned, params)
                i = ev["count"]
                room = i < max_ev
                # overflow is a typed failure, not a silent drop: the
                # backward pass would skip this event's correction
                after = after.replace(status=jnp.where(
                    room, after.status,
                    jnp.asarray(errors.EVENT_CAPACITY_EXCEEDED, jnp.int32),
                ))
                upd = lambda a, v: jnp.where(room, a.at[i].set(v), a)
                ev2 = dict(
                    t=upd(ev["t"], pinned.t),
                    y_minus=upd(ev["y_minus"], pinned.y),
                    dy_minus=upd(ev["dy_minus"], pinned.dy),
                    y_plus=upd(ev["y_plus"], after.y),
                    dy_plus=upd(ev["dy_plus"], after.dy),
                    idx=upd(ev["idx"], new.root_idx),
                    count=jnp.where(room, i + 1, i),
                )
                # two table knots at t*: the pre- and post-event states
                r2 = 2 * i + k + 1
                upd2 = lambda tab, a, b: jnp.where(
                    room, tab.at[r2].set(a).at[r2 + 1].set(b), tab
                )
                ts2 = upd2(ts_tab, pinned.t, after.t)
                ys2 = upd2(ys_tab, pinned.y, after.y)
                dys2 = upd2(dys_tab, pinned.dy, after.dy)
                return after, ev2, ts2, ys2, dys2

            def no_root(args):
                new, ev, ts_tab, ys_tab, dys_tab = args
                return (
                    new, ev,
                    write(ts_tab, new.t),
                    write(ys_tab, new.y),
                    write(dys_tab, new.dy),
                )

            new, ev, ts_tab, ys_tab, dys_tab = jax.lax.cond(
                is_root, on_root, no_root,
                (new, ev, ts_tab, ys_tab, dys_tab),
            )
            fatal = fatal | (new.status < 0)
            root_done = is_root & (new.t >= final_time)
            done = fatal | is_tstop | root_done
        else:
            ts_tab = write(ts_tab, new.t)
            ys_tab = write(ys_tab, new.y)
            dys_tab = write(dys_tab, new.dy)
            done = fatal | is_tstop
        return (new, ys, ts_tab, ys_tab, dys_tab, ev, k + 1, done, t_upper)

    init = (
        state, ys, ts_tab, ys_tab, dys_tab, ev,
        jnp.asarray(0, jnp.int32), state.status < 0,
        jnp.asarray(-jnp.inf, dtype),
    )
    (state, ys, ts_tab, ys_tab, dys_tab, ev, k, _done, _w) = jax.lax.while_loop(
        cond, body, init
    )
    # loud failure: poison the outputs so a fatal status (incl. event-record
    # overflow) can never flow silently into gradients
    ys = jnp.where(state.status < 0, jnp.nan, ys)
    g = jnp.where(state.status < 0, jnp.nan, state.g)
    return ys, g, (ts_tab, ys_tab, dys_tab, k), ev, state.status


def _empty_events(max_ev, yshape, dtype):
    if isinstance(yshape, int):  # legacy callers pass n
        yshape = (yshape,)
    return dict(
        t=jnp.full((max_ev,), jnp.inf, dtype),
        y_minus=jnp.zeros((max_ev,) + yshape, dtype),
        dy_minus=jnp.zeros((max_ev,) + yshape, dtype),
        y_plus=jnp.zeros((max_ev,) + yshape, dtype),
        dy_plus=jnp.zeros((max_ev,) + yshape, dtype),
        idx=jnp.full((max_ev,), -1, jnp.int32),
        count=jnp.asarray(0, jnp.int32),
    )


def forward_with_checkpoints(solver, t_eval, params, max_steps: int,
                             interval: int, max_events: int = MAX_EVENTS):
    """Forward solve recording sparse FULL-STATE checkpoints.

    The bounded-memory analog of :func:`forward_with_table` (reference
    Checkpointing, checkpointing.rs:91-250): instead of (t, y, dy) at every
    step, the complete solver state pytree is stored every ``interval``
    accepted steps.  Memory O((max_steps/interval) * state) -- the backward
    pass re-solves each segment to rebuild its local dense table.

    Returns (ys, g, (ck_ts, ck_states, n_ck), events); segment s spans
    [ck_ts[s], ck_ts[s+1]] for s < n_ck - 1.
    """
    from .drivers import _apply_reset, _pin_to

    p = solver.problem
    has_reset = p.eqn.root is not None and p.eqn.reset is not None
    max_ev = max_events if has_reset else 0
    state = init_state_jit(solver, params)
    t_eval = jnp.asarray(t_eval, state.t.dtype)
    dtype = state.y.dtype
    neval = t_eval.shape[0]
    yshape = state.y.shape  # (n,) single / (n, B) lockstep
    final_time = t_eval[-1]
    state = solver.set_stop_time(state, final_time)

    n_slots = max_steps // interval + 2
    ck_states = jax.tree_util.tree_map(
        lambda x: jnp.zeros((n_slots,) + jnp.shape(x), jnp.asarray(x).dtype),
        state,
    )
    ck_ts = jnp.full((n_slots,), jnp.inf, dtype)

    def write_ck(bufs, ts, st, i):
        bufs = jax.tree_util.tree_map(lambda b, v: b.at[i].set(v), bufs, st)
        return bufs, ts.at[i].set(st.t)

    ck_states, ck_ts = write_ck(ck_states, ck_ts, state, 0)
    ys = jnp.zeros((neval,) + yshape, dtype)
    ev = _empty_events(max_ev, yshape, dtype)

    def cond(c):
        (_s, _ys, _ct, _cs, _ev, k, done, _w, _ci) = c
        return (~done) & (k < max_steps)

    def body(c):
        (state, ys, ck_ts, ck_states, ev, k, _done, written_to, ck_i) = c
        new = solver.step(state, params)
        status = new.status
        fatal = status < 0
        is_tstop = status == errors.TSTOP_REACHED
        is_root = has_reset & (status == errors.ROOT_FOUND)
        t_upper = jnp.where(is_root, new.root_t, new.t)
        t_upper = jnp.where(is_tstop, jnp.maximum(new.t, final_time), t_upper)
        t_upper = jnp.where(fatal, written_to, t_upper)
        mask = (t_eval <= t_upper) & (t_eval > written_to)
        y_interp = jax.vmap(lambda tt: solver.interpolate(new, tt))(t_eval)
        ys = jnp.where(mask.reshape((-1,) + (1,) * len(yshape)), y_interp, ys)

        if has_reset:
            def on_root(args):
                new, ev = args
                pinned = _pin_to(solver, new, new.root_t)
                after = _apply_reset(solver, pinned, params)
                i = ev["count"]
                room = i < max_ev
                after = after.replace(status=jnp.where(
                    room, after.status,
                    jnp.asarray(errors.EVENT_CAPACITY_EXCEEDED, jnp.int32),
                ))
                upd = lambda a, v: jnp.where(room, a.at[i].set(v), a)
                ev2 = dict(
                    t=upd(ev["t"], pinned.t),
                    y_minus=upd(ev["y_minus"], pinned.y),
                    dy_minus=upd(ev["dy_minus"], pinned.dy),
                    y_plus=upd(ev["y_plus"], after.y),
                    dy_plus=upd(ev["dy_plus"], after.dy),
                    idx=upd(ev["idx"], new.root_idx),
                    count=jnp.where(room, i + 1, i),
                )
                return after, ev2

            new, ev = jax.lax.cond(
                is_root, on_root, lambda a: a, (new, ev)
            )
            fatal = fatal | (new.status < 0)
            root_done = is_root & (new.t >= final_time)
            done = fatal | is_tstop | root_done
        else:
            done = fatal | is_tstop

        # sparse checkpoint every `interval` accepted steps (post-reset
        # state if this step hit an event, so the re-solve continues from
        # exactly the state the original forward continued from)
        do_ck = (~fatal) & (~done) & (((k + 1) % interval) == 0)

        def ck_write(args):
            cs, ct, ci = args
            cs, ct = write_ck(cs, ct, new, ci + 1)
            return cs, ct, ci + 1

        ck_states, ck_ts, ck_i = jax.lax.cond(
            do_ck, ck_write, lambda a: a, (ck_states, ck_ts, ck_i)
        )
        return (new, ys, ck_ts, ck_states, ev, k + 1, done, t_upper, ck_i)

    init = (
        state, ys, ck_ts, ck_states, ev,
        jnp.asarray(0, jnp.int32), state.status < 0,
        jnp.asarray(-jnp.inf, dtype), jnp.asarray(0, jnp.int32),
    )
    (state, ys, ck_ts, ck_states, ev, _k, _done, _w, ck_i) = (
        jax.lax.while_loop(cond, body, init)
    )
    # final checkpoint: the end state (defines the last segment's t_end)
    ck_states, ck_ts = write_ck(ck_states, ck_ts, state, ck_i + 1)
    n_ck = ck_i + 2
    ys = jnp.where(state.status < 0, jnp.nan, ys)
    g = jnp.where(state.status < 0, jnp.nan, state.g)
    return ys, g, (ck_ts, ck_states, n_ck), ev, state.status


def _record_segment(solver, state0, t_end, params, seg_steps: int,
                    max_events: int = MAX_EVENTS):
    """Re-solve [state0.t, t_end] recording the (t, y, dy) dense table.

    The bounded-memory backward pass's segment re-solve (reference
    checkpointing.rs:91-119 segment Hermite interpolator).  Root/reset
    events inside the segment are re-found and re-applied -- the re-solve
    starts from the exact original solver state, so it reproduces the
    original step sequence (up to the tstop truncation at t_end).  Event
    boundaries get double knots exactly as in :func:`forward_with_table`.
    """
    from .drivers import _apply_reset, _pin_to

    p = solver.problem
    has_reset = p.eqn.root is not None and p.eqn.reset is not None
    max_ev = max_events if has_reset else 0
    dtype = state0.y.dtype
    yshape = state0.y.shape
    nrows = seg_steps + 2 * max_ev + 1
    ts_tab = jnp.full((nrows,), jnp.inf, dtype)
    ys_tab = jnp.zeros((nrows,) + yshape, dtype)
    dys_tab = jnp.zeros((nrows,) + yshape, dtype)
    ts_tab = ts_tab.at[0].set(state0.t)
    ys_tab = ys_tab.at[0].set(state0.y)
    dys_tab = dys_tab.at[0].set(state0.dy)
    state = solver.set_stop_time(
        state0.replace(status=jnp.asarray(errors.INTERNAL_TIMESTEP, jnp.int32)),
        t_end,
    )

    def cond(c):
        (_s, _tt, _yt, _dt, nev, k, done) = c
        return (~done) & (k < seg_steps)

    def body(c):
        (state, ts_tab, ys_tab, dys_tab, nev, k, _done) = c
        new = solver.step(state, params)
        status = new.status
        fatal = status < 0
        is_tstop = status == errors.TSTOP_REACHED
        is_root = has_reset & (status == errors.ROOT_FOUND)
        row = 2 * nev + k + 1
        write = lambda tab, val: jnp.where(fatal, tab, tab.at[row].set(val))

        if has_reset:
            def on_root(args):
                new, ts_tab, ys_tab, dys_tab, nev = args
                pinned = _pin_to(solver, new, new.root_t)
                after = _apply_reset(solver, pinned, params)
                # capacity guard: without it a >max_ev event count would
                # compute a row past the table and JAX would clamp the
                # scatter onto the LAST row, silently corrupting it
                room = nev < max_ev
                r2 = 2 * nev + k + 1
                upd2 = lambda tab, a, b: jnp.where(
                    room, tab.at[r2].set(a).at[r2 + 1].set(b), tab
                )
                ts2 = upd2(ts_tab, pinned.t, after.t)
                ys2 = upd2(ys_tab, pinned.y, after.y)
                dys2 = upd2(dys_tab, pinned.dy, after.dy)
                return after, ts2, ys2, dys2, jnp.where(room, nev + 1, nev)

            def no_root(args):
                new, ts_tab, ys_tab, dys_tab, nev = args
                return (
                    new,
                    write(ts_tab, new.t),
                    write(ys_tab, new.y),
                    write(dys_tab, new.dy),
                    nev,
                )

            new, ts_tab, ys_tab, dys_tab, nev = jax.lax.cond(
                is_root, on_root, no_root,
                (new, ts_tab, ys_tab, dys_tab, nev),
            )
            root_done = is_root & (new.t >= t_end)
            done = fatal | is_tstop | root_done
        else:
            ts_tab = write(ts_tab, new.t)
            ys_tab = write(ys_tab, new.y)
            dys_tab = write(dys_tab, new.dy)
            done = fatal | is_tstop
        return (new, ts_tab, ys_tab, dys_tab, nev, k + 1, done)

    init = (
        state, ts_tab, ys_tab, dys_tab,
        jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
        state.status < 0,
    )
    (_s, ts_tab, ys_tab, dys_tab, _nev, _k, _done) = jax.lax.while_loop(
        cond, body, init
    )
    return ts_tab, ys_tab, dys_tab


def hermite_interp(table, t):
    """Cubic Hermite interpolation of the forward trajectory at time t
    (reference HermiteInterpolator, checkpointing.rs:16-90)."""
    ts, ys, dys = table[0], table[1], table[2]
    k = jnp.clip(jnp.searchsorted(ts, t, side="right"), 1, ys.shape[0] - 1)
    t0, t1 = ts[k - 1], ts[k]
    # guard the padded +inf region: clamp interval to the last finite knot
    t1 = jnp.where(jnp.isfinite(t1), t1, t0)
    y0, y1 = ys[k - 1], ys[k]
    f0, f1 = dys[k - 1], dys[k]
    dt = t1 - t0
    safe_dt = jnp.where(dt == 0.0, 1.0, dt)
    # dt == 0 happens at the padded-+inf table edge (t == last knot) and at
    # duplicated event knots: return the LEFT knot (the right one may be the
    # zero-padded region)
    theta = jnp.where(dt == 0.0, 0.0, (t - t0) / safe_dt)
    h00 = (1.0 + 2.0 * theta) * (1.0 - theta) ** 2
    h10 = theta * (1.0 - theta) ** 2
    h01 = theta**2 * (3.0 - 2.0 * theta)
    h11 = theta**2 * (theta - 1.0)
    return h00 * y0 + h10 * safe_dt * f0 + h01 * y1 + h11 * safe_dt * f1


# --------------------------------------------------------------------------
# backward pass
# --------------------------------------------------------------------------


def _adjoint_problem(problem: OdeProblem, t_top, nparams: int, ct_g=None,
                     table=None, table_rows: Optional[int] = None):
    """Build the time-reversed augmented adjoint problem in sigma = t_top - t.

    State z = [lambda (n), g_p (nparams)]:
        M^T dlambda/dsigma = +J(x(t))^T lambda [+ u_y(x)^T ct_g]
        dg_p/dsigma        = +f_p(x(t))^T lambda [+ u_p(x)^T ct_g]
    (adjoint_equations.rs:330-360 AdjointRhs with/without `with_out`,
    :377-460 AdjointOut).  ``ct_g`` is the cotangent of the quadrature
    output G = int u dt (None for pure output-time objectives).

    The forward trajectory x(t) is Hermite-interpolated from ``table``
    (dense mode: a static closure) or, in bounded-memory mode
    (``table=None``), from a ``table_rows``-row local table PACKED INTO THE
    PARAMS VECTOR after the real parameters -- the params argument is the
    only data channel through the solver machinery, and the local table
    changes per segment.

    The mass matrix becomes blockdiag(M^T, I) on the augmented system (the
    reference's AdjointMass transpose operator, adjoint_equations.rs:142-200);
    a SINGULAR M makes the corresponding lambda rows algebraic, handled by
    the solver's consistent-IC machinery exactly as on the forward problem.
    """
    eqn = problem.eqn
    n = eqn.nstates
    dtype = problem.atol.dtype

    if table is not None:
        def split(params):
            return params, table

        params_ph = problem.params
    else:
        if table_rows is None:
            raise ValueError("need table or table_rows")
        R = table_rows

        def split(params):
            rp = params[:nparams]
            ts = params[nparams:nparams + R]
            off = nparams + R
            ys = params[off:off + R * n].reshape(R, n)
            dys = params[off + R * n:off + 2 * R * n].reshape(R, n)
            return rp, (ts, ys, dys)

        # placeholder: real default params + zeroed table (setup-time probes
        # like the algebraic-row mask evaluate mass/rhs against this)
        params_ph = jnp.concatenate([
            jnp.asarray(problem.params, dtype).reshape(-1),
            jnp.zeros((R + 2 * R * n,), dtype),
        ])

    def rhs(sigma, z, params):
        rp, tab = split(params)
        t = t_top - sigma
        x = hermite_interp(tab, t)
        lam = z[:n]
        _, vjp_y = jax.vjp(lambda yy: eqn.rhs(t, yy, rp), x)
        _, vjp_p = jax.vjp(lambda pp: eqn.rhs(t, x, pp), rp)
        dlam = vjp_y(lam)[0]
        dgp = vjp_p(lam)[0]
        if ct_g is not None:
            out_fn = eqn.out if eqn.out is not None else (
                lambda tt, yy, pp: yy
            )
            _, vjp_uy = jax.vjp(lambda yy: out_fn(t, yy, rp), x)
            _, vjp_up = jax.vjp(lambda pp: out_fn(t, x, pp), rp)
            dlam = dlam + vjp_uy(ct_g)[0]
            dgp = dgp + vjp_up(ct_g)[0]
        return jnp.concatenate([dlam, dgp])

    def init(sigma, params):
        return jnp.zeros((n + nparams,), dtype)

    adj_mass = None
    if eqn.mass is not None:
        def adj_mass(sigma, params):
            rp, _tab = split(params)
            m_t = eqn.mass(t_top - sigma, rp).T
            out = jnp.eye(n + nparams, dtype=m_t.dtype)
            return out.at[:n, :n].set(m_t)

    adj_eqn = make_equations(rhs, init, params_ph, 0.0, mass=adj_mass)
    # gp-row tolerances: param_atol (scaled by param_scales) when configured
    # (reference adjoint_equations.rs:580-581), else the mean state atol
    if problem.param_atol is not None:
        gp_atol = problem.param_atol
        if problem.param_scales is not None:
            gp_atol = gp_atol * problem.param_scales
    else:
        gp_atol = jnp.full((nparams,), jnp.mean(problem.atol))
    atol = jnp.concatenate([problem.atol, gp_atol])
    # the augmented (n + nparams) adjoint system has a dense jacfwd Jacobian
    # regardless of the forward problem's structure: a banded/auto-routed
    # forward spec must NOT leak into it (its band arrays would be shaped
    # for n, not n + nparams)
    from .ops import linsol

    return dataclasses.replace(
        problem,
        eqn=adj_eqn,
        params=jnp.asarray(params_ph, dtype),
        atol=atol,
        t0=jnp.asarray(0.0, dtype),
        h0=jnp.asarray(0.0, dtype),
        integrate_out=False,
        linear_solver=linsol.DENSE,
    )


def _make_jump(problem):
    """Discrete output-jump operator: (lam, gp, v, t, x, params) -> (lam, gp).

    Identity-mass: lam += v.  Regular mass: lam += M^{-T} v.  Singular-mass
    DAE: the differential/algebraic partition
    lambda_d += M_dd^{-1}(v_d - A_da A_aa^{-1} v_a), A = f_y^T, plus the
    parameter term -f_{p,a}^T A_aa^{-1} v_a
    (reference adjoint.rs:292-366 apply_delta_g_out_mass_alg).  ``x`` is the
    interpolated forward state at t (used only in the singular branch).
    ``params`` is an explicit argument so lockstep ensembles can ``vmap``
    the jump over per-member parameter rows.
    """
    from .solvers.consistent_ic import algebraic_mask
    from .ops import linsol

    eqn = problem.eqn
    dtype = problem.atol.dtype
    alg = algebraic_mask(problem) if eqn.mass is not None else None

    if eqn.mass is None:
        def jump(lam, gp_rows, v, t, x, params):
            return lam + v, gp_rows
    elif alg is None:
        def jump(lam, gp_rows, v, t, x, params):
            m_t = eqn.mass(t, params).T
            return (
                lam + linsol.DENSE.solve(linsol.DENSE.factor(m_t), v),
                gp_rows,
            )
    else:
        alg_np = jnp.asarray(alg)

        @highest_precision
        def jump(lam, gp_rows, v, t, x, params):
            J = jax.jacfwd(lambda yy: eqn.rhs(t, yy, params))(x)
            A = J.T
            diag_d = jnp.diag(jnp.where(alg_np, 0.0, 1.0).astype(dtype))
            Ap = jnp.where(alg_np[:, None] & alg_np[None, :], A, 0.0) + diag_d
            va = linsol.DENSE.solve(
                linsol.DENSE.factor(Ap), jnp.where(alg_np, v, 0.0)
            )
            va = jnp.where(alg_np, va, 0.0)
            w = jnp.where(alg_np, 0.0, v - A @ va)
            m_t = eqn.mass(t, params).T
            diag_a = jnp.diag(jnp.where(alg_np, 1.0, 0.0).astype(dtype))
            Mp = (
                jnp.where(
                    (~alg_np)[:, None] & (~alg_np)[None, :], m_t, 0.0
                )
                + diag_a
            )
            lam_d = linsol.DENSE.solve(linsol.DENSE.factor(Mp), w)
            lam = lam + jnp.where(alg_np, 0.0, lam_d)
            # parameter contribution of the algebraic constraint
            _, vjp_p = jax.vjp(lambda pp: eqn.rhs(t, x, pp), params)
            gp_rows = gp_rows - vjp_p(va)[0]
            return lam, gp_rows

    return jump


def _event_correction_core(eqn, dtype, out_fn, with_ct_g: bool):
    """Per-member reset-event adjoint boundary correction.

    lambda- = R_y^T lambda+ - alpha r_{y,k}^T,
    gp += R_p^T lambda+ - alpha r_{p,k}^T,
    alpha = (lambda+ . c + (u- - u+) . ct_g) / d,
    c = R_y f- + R_t - f+, d = (r_y f- + r_t)_k
    (reference adjoint.rs:106-148 + state.rs:560-692
    apply_reset_with_adjoint).

    All operands are explicit single-member arrays so the lockstep-ensemble
    path (:mod:`diffsol_tpu.adjoint_ensemble`) can ``vmap`` this over the
    member axis -- the single-instance path binds them from the recorded
    events dict in :func:`_make_event_correction`.
    """

    def correct1(lam, gp_rows, t_star, y_m, dy_m, y_p, dy_p, k, params,
                 ct_g_m):
        if eqn.reset_n is not None:
            reset_f = lambda yy: eqn.reset_n(t_star, yy, params, k)
            reset_t = lambda tt: eqn.reset_n(tt, y_m, params, k)
            reset_p = lambda pp: eqn.reset_n(t_star, y_m, pp, k)
        else:
            reset_f = lambda yy: eqn.reset(t_star, yy, params)
            reset_t = lambda tt: eqn.reset(tt, y_m, params)
            reset_p = lambda pp: eqn.reset(t_star, y_m, pp)
        root_f = lambda yy: eqn.root(t_star, yy, params)
        R_t = jax.jvp(
            reset_t, (t_star,),
            (jnp.ones_like(t_star),),
        )[1]
        r_t = jax.jvp(
            lambda tt: eqn.root(tt, y_m, params), (t_star,),
            (jnp.ones_like(t_star),),
        )[1]
        _, vjp_Ry = jax.vjp(reset_f, y_m)
        c_dir = jax.jvp(reset_f, (y_m,), (dy_m,))[1] + R_t - dy_p
        d = (jax.jvp(root_f, (y_m,), (dy_m,))[1] + r_t)[k]
        alpha_num = jnp.sum(lam * c_dir)
        if with_ct_g:
            u_m = out_fn(t_star, y_m, params)
            u_p = out_fn(t_star, y_p, params)
            alpha_num = alpha_num + jnp.sum((u_m - u_p) * ct_g_m)
        alpha = alpha_num / d
        nroots = eqn.nroots
        e_k = jnp.zeros((nroots,), dtype).at[k].set(alpha)
        _, vjp_ry = jax.vjp(root_f, y_m)
        lam_new = vjp_Ry(lam)[0] - vjp_ry(e_k)[0]
        _, vjp_Rp = jax.vjp(reset_p, params)
        _, vjp_rp = jax.vjp(lambda pp: eqn.root(t_star, y_m, pp), params)
        gp_new = gp_rows + vjp_Rp(lam)[0] - vjp_rp(e_k)[0]
        return lam_new, gp_new

    return correct1


def _make_event_correction(problem, events, params, ct_g, out_fn):
    """Reset-event adjoint boundary correction: (lam, gp, slot) -> (lam, gp).

    Single-instance binding of :func:`_event_correction_core` to the
    recorded events dict (see there for the formulas + reference citation).
    """
    core = _event_correction_core(
        problem.eqn, problem.atol.dtype, out_fn, ct_g is not None
    )

    def correct(lam, gp_rows, slot):
        return core(
            lam, gp_rows,
            events["t"][slot],
            events["y_minus"][slot], events["dy_minus"][slot],
            events["y_plus"][slot], events["dy_plus"][slot],
            events["idx"][slot], params, ct_g,
        )

    return correct


def _make_reinit(solver, adj_problem):
    """Mark modified + restore DAE consistency of the lambda rows."""

    def reinit(state, params):
        state = state.replace(state_modified=jnp.asarray(True))
        if hasattr(solver, "reinit_after_reset"):
            return solver.reinit_after_reset(state, params)
        return state.replace(
            dy=adj_problem.eqn.rhs(state.t, state.y, params)
        )

    return reinit


def _integrate_to(solver, state, target_sigma, params, max_steps):
    """Advance the adjoint solver to target_sigma (no-op if already there)."""

    def run(args):
        state, params = args
        state = solver.set_stop_time(
            state.replace(
                status=jnp.asarray(errors.INTERNAL_TIMESTEP, jnp.int32)
            ),
            target_sigma,
        )

        def cond(c):
            s, k = c
            return (s.status == errors.INTERNAL_TIMESTEP) & (k < max_steps)

        def body(c):
            s, k = c
            return solver.step(s, params), k + 1

        state, _ = jax.lax.while_loop(
            cond, body, (state, jnp.asarray(0, jnp.int32))
        )
        return (state, params)

    (state, _) = jax.lax.cond(
        target_sigma > state.t, run, lambda a: a, (state, params)
    )
    return state


def _boundary_schedule(t_eval, events, dtype):
    """Merged output-time + reset-event boundary list, descending in t.

    Returns (bt, btype, bslot, order): btype 0 = output jump (slot into
    t_eval/ct_ys), 1 = reset-event correction (slot into events).
    """
    neval = t_eval.shape[0]
    max_ev = events["t"].shape[0]
    ev_valid = jnp.arange(max_ev) < events["count"]
    ev_t = jnp.where(ev_valid, events["t"], -jnp.inf)
    bt = jnp.concatenate([t_eval, ev_t])
    btype = jnp.concatenate(
        [jnp.zeros((neval,), jnp.int32), jnp.ones((max_ev,), jnp.int32)]
    )
    bslot = jnp.concatenate(
        [jnp.arange(neval, dtype=jnp.int32),
         jnp.arange(max_ev, dtype=jnp.int32)]
    )
    order = jnp.argsort(-bt)
    return bt, btype, bslot, order


def backward_pass(problem, solver_cls, table, events, t_eval, ct_ys, params,
                  max_steps, ct_g=None):
    """Integrate the adjoint backward through all output times and reset
    events (dense-table mode).

    ``ct_ys``: (neval, n) cotangents dG/dy(t_i) (zeros allowed);
    ``ct_g``: optional (nout,) cotangent of the quadrature output
    G = int u dt.  Returns dG/dp (nparams,).

    Handles discrete output jumps (incl. the singular-mass DAE partition),
    reset-event boundary corrections, and the init-condition correction --
    see :func:`_make_jump`, :func:`_make_event_correction` and
    :func:`_init_correction` for the reference citations.
    """
    eqn = problem.eqn
    n = eqn.nstates
    dtype = problem.atol.dtype
    nparams = int(params.shape[0])
    t_eval = jnp.asarray(t_eval, dtype)
    neval = t_eval.shape[0]
    t_top = t_eval[-1]
    t0 = problem.t0

    adj_problem = _adjoint_problem(problem, t_top, nparams, ct_g=ct_g,
                                   table=table)
    solver = solver_cls(adj_problem)
    state = init_state_jit(solver, params)

    jump = _make_jump(problem)
    out_fn = eqn.out if eqn.out is not None else (lambda tt, yy, pp: yy)
    correct = _make_event_correction(problem, events, params, ct_g, out_fn)
    reinit = _make_reinit(solver, adj_problem)
    bt, btype, bslot, order = _boundary_schedule(t_eval, events, dtype)
    max_ev = events["t"].shape[0]
    sigma_end = t_top - t0

    def apply_output_jump(state, slot):
        t = t_top - state.t
        x = hermite_interp(table, t)
        lam, gp_rows = state.y[:n], state.y[n:]
        lam, gp_rows = jump(lam, gp_rows, ct_ys[slot], t, x, params)
        return reinit(
            state.replace(y=jnp.concatenate([lam, gp_rows])), params
        )

    def apply_event_correction(state, slot):
        lam, gp_rows = state.y[:n], state.y[n:]
        lam_new, gp_new = correct(lam, gp_rows, slot)
        return reinit(
            state.replace(y=jnp.concatenate([lam_new, gp_new])), params
        )

    def seg_body(i, state):
        j = order[i]
        t_b = bt[j]
        valid = jnp.isfinite(t_b)

        def process(state):
            state = _integrate_to(
                solver, state, t_top - t_b, params, max_steps
            )
            if eqn.reset is not None and eqn.root is not None:
                return jax.lax.cond(
                    btype[j] == 0,
                    lambda s: apply_output_jump(s, bslot[j]),
                    lambda s: apply_event_correction(s, bslot[j]),
                    state,
                )
            return apply_output_jump(state, bslot[j])

        return jax.lax.cond(valid, process, lambda s: s, state)

    state = jax.lax.fori_loop(0, neval + max_ev, seg_body, state)
    state = _integrate_to(solver, state, sigma_end, params, max_steps)
    return _init_correction(problem, params, state.y[:n], state.y[n:])


def backward_pass_bounded(problem, solver_cls, fwd_solver, ckpts, events,
                          t_eval, ct_ys, params, max_steps, interval,
                          ct_g=None):
    """Bounded-memory adjoint backward pass (reference checkpointing.rs:91-250
    + method.rs:620-705 segment re-solve).

    Walks the sparse checkpoints top-down; each segment is re-solved forward
    from its full-state checkpoint (:func:`_record_segment`) to rebuild an
    ``interval``-row local Hermite table, which rides into the adjoint
    solver inside the params vector (see :func:`_adjoint_problem`).  Output
    jumps and event corrections fire inside the segment that contains them.
    Storage: O(n_segments * state + interval * n) -- never the full dense
    step table.
    """
    eqn = problem.eqn
    n = eqn.nstates
    dtype = problem.atol.dtype
    nparams = int(params.shape[0])
    t_eval = jnp.asarray(t_eval, dtype)
    neval = t_eval.shape[0]
    t_top = t_eval[-1]
    ck_ts, ck_states, n_ck = ckpts
    n_slots = ck_ts.shape[0]

    has_events = eqn.reset is not None and eqn.root is not None
    seg_steps = interval + 4  # margin for the tstop-truncated last step
    max_ev = events["t"].shape[0]
    R = seg_steps + 2 * max_ev + 1

    adj_problem = _adjoint_problem(problem, t_top, nparams, ct_g=ct_g,
                                   table=None, table_rows=R)
    solver = solver_cls(adj_problem)

    jump = _make_jump(problem)
    out_fn = eqn.out if eqn.out is not None else (lambda tt, yy, pp: yy)
    correct = _make_event_correction(problem, events, params, ct_g, out_fn)
    reinit = _make_reinit(solver, adj_problem)
    bt, btype, bslot, order = _boundary_schedule(t_eval, events, dtype)

    def seg_params(s):
        st = jax.tree_util.tree_map(lambda b: b[s], ck_states)
        t_end = ck_ts[s + 1]
        ts_l, ys_l, dys_l = _record_segment(
            fwd_solver, st, t_end, params, seg_steps, max_events=max_ev
        )
        pa = jnp.concatenate([params, ts_l, ys_l.ravel(), dys_l.ravel()])
        return pa, (ts_l, ys_l, dys_l)

    # adjoint init needs the TOP segment's table in params (rhs is probed
    # at sigma = 0 by the initial-step-size heuristic); the segment loop
    # REUSES this re-solve for the top segment instead of recomputing it
    top = seg_params(n_ck - 2)
    state = init_state_jit(solver, top[0])

    def apply_output_jump(state, slot, pa, tab):
        t = t_top - state.t
        x = hermite_interp(tab, t)
        lam, gp_rows = state.y[:n], state.y[n:]
        lam, gp_rows = jump(lam, gp_rows, ct_ys[slot], t, x, params)
        return reinit(state.replace(y=jnp.concatenate([lam, gp_rows])), pa)

    def apply_event_correction(state, slot, pa):
        lam, gp_rows = state.y[:n], state.y[n:]
        lam_new, gp_new = correct(lam, gp_rows, slot)
        return reinit(state.replace(y=jnp.concatenate([lam_new, gp_new])), pa)

    def seg_body(i, state):
        s = n_slots - 2 - i
        valid = (s >= 0) & (s <= n_ck - 2)

        def process(state):
            is_top = s == n_ck - 2
            pa, tab = jax.lax.cond(
                is_top, lambda: top, lambda: seg_params(s)
            )
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
                            lambda st: apply_output_jump(st, bslot[j], pa, tab),
                            lambda st: apply_event_correction(st, bslot[j], pa),
                            state,
                        )
                    return apply_output_jump(state, bslot[j], pa, tab)

                return jax.lax.cond(inside, apply, lambda st: st, state)

            state = jax.lax.fori_loop(0, neval + max_ev, bnd_body, state)
            # finish the segment: integrate to its start time
            return _integrate_to(
                solver, state, t_top - ck_ts[s], pa, max_steps
            )

        return jax.lax.cond(valid, process, lambda st: st, state)

    state = jax.lax.fori_loop(0, n_slots - 1, seg_body, state)
    return _init_correction(problem, params, state.y[:n], state.y[n:])


@highest_precision
def _init_correction(problem, params, lam0, gp):
    """Initial-condition correction (adjoint.rs:151-156 correct_sg_for_init):
    dG/dp += (dy0/dp)^T M^T lambda(t0)  (M from the Lagrangian term
    lambda^T (M y' - f); identity when no mass matrix; a singular M
    automatically zeroes the algebraic rows)."""
    eqn = problem.eqn
    if eqn.mass is not None:
        lam0 = eqn.mass(problem.t0, params).T @ lam0
    y0_p = jax.jacfwd(lambda pp: eqn.init(problem.t0, pp))(params)  # (n, np)
    return gp + y0_p.T @ lam0


# --------------------------------------------------------------------------
# custom_vjp wrapper: jax.grad through the solver
# --------------------------------------------------------------------------


def make_differentiable_solve(
    problem: OdeProblem,
    t_eval,
    solver_cls=None,
    max_steps: int = 16_384,
    bwd_solver_cls=None,
    bwd_max_steps: Optional[int] = None,
    checkpoint_interval: Optional[int] = None,
    max_events: int = MAX_EVENTS,
):
    """Return ``ys_of(params) -> (neval, n)`` differentiable via the adjoint.

    Forward-mode (jvp/jacfwd) falls through to the solver itself; reverse
    mode (grad/vjp) runs the checkpointed adjoint backward pass.

    ``checkpoint_interval=K`` selects the bounded-memory mode: the forward
    pass stores a full solver-state checkpoint every K accepted steps
    instead of the dense (t, y, dy) step table, and the backward pass
    re-solves each segment on demand (reference Checkpointing,
    checkpointing.rs:91-250).  Storage O(max_steps/K * state + K * n); use
    for long horizons or large n where the dense table exceeds HBM.

    ``max_events`` bounds the static reset-event record; overflowing it
    fails LOUDLY (outputs/gradients become NaN and the forward status is
    errors.EVENT_CAPACITY_EXCEEDED) instead of silently dropping event
    corrections.
    """
    from .solvers.bdf import BdfSolver

    solver_cls = solver_cls or BdfSolver
    bwd_solver_cls = bwd_solver_cls or solver_cls
    bwd_max_steps = bwd_max_steps or max_steps
    solver = solver_cls(problem)
    t_eval = jnp.asarray(t_eval)

    if checkpoint_interval is None:
        @jax.custom_vjp
        def ys_of(params):
            ys, _g, _table, _ev, _st = forward_with_table(
                solver, t_eval, params, max_steps, max_events
            )
            return ys

        def fwd(params):
            ys, _g, table, ev, _st = forward_with_table(
                solver, t_eval, params, max_steps, max_events
            )
            return ys, (params, table, ev)

        def bwd(res, ct_ys):
            params, table, ev = res
            grad_p = backward_pass(
                problem, bwd_solver_cls, table, ev, t_eval, ct_ys, params,
                bwd_max_steps,
            )
            return (grad_p,)
    else:
        K = int(checkpoint_interval)

        @jax.custom_vjp
        def ys_of(params):
            ys, _g, _ck, _ev, _st = forward_with_checkpoints(
                solver, t_eval, params, max_steps, K, max_events
            )
            return ys

        def fwd(params):
            ys, _g, ckpts, ev, _st = forward_with_checkpoints(
                solver, t_eval, params, max_steps, K, max_events
            )
            return ys, (params, ckpts, ev)

        def bwd(res, ct_ys):
            params, ckpts, ev = res
            grad_p = backward_pass_bounded(
                problem, bwd_solver_cls, solver, ckpts, ev, t_eval, ct_ys,
                params, bwd_max_steps, K,
            )
            return (grad_p,)

    ys_of.defvjp(fwd, bwd)
    return ys_of


def make_differentiable_quadrature(
    problem: OdeProblem,
    t_final,
    solver_cls=None,
    max_steps: int = 16_384,
    bwd_solver_cls=None,
    bwd_max_steps: Optional[int] = None,
    checkpoint_interval: Optional[int] = None,
    max_events: int = MAX_EVENTS,
):
    """Return ``g_of(params) -> (nout,)``: the quadrature output
    G = int_{t0}^{t_final} u(t, y, p) dt, reverse-differentiable through the
    continuous adjoint with the -u_y^T forcing term (reference AdjointRhs
    `with_out`, adjoint_equations.rs:330-360, and AdjointOut :377-460).

    The problem must be built with ``integrate_out`` (the forward pass
    accumulates g); ``u`` defaults to the identity on the state when no
    ``out`` function is configured, matching the reference.
    ``checkpoint_interval`` selects the bounded-memory checkpointing mode
    (see :func:`make_differentiable_solve`).
    """
    from .solvers.bdf import BdfSolver

    if not problem.integrate_out:
        raise ValueError(
            "make_differentiable_quadrature needs a problem built with "
            ".integrate_out()"
        )
    solver_cls = solver_cls or BdfSolver
    bwd_solver_cls = bwd_solver_cls or solver_cls
    bwd_max_steps = bwd_max_steps or max_steps
    solver = solver_cls(problem)
    t_eval = jnp.asarray([t_final])

    if checkpoint_interval is None:
        @jax.custom_vjp
        def g_of(params):
            _ys, g, _table, _ev, _st = forward_with_table(
                solver, t_eval, params, max_steps, max_events
            )
            return g

        def fwd(params):
            _ys, g, table, ev, _st = forward_with_table(
                solver, t_eval, params, max_steps, max_events
            )
            return g, (params, table, ev)

        def bwd(res, ct_g):
            params, table, ev = res
            n = problem.eqn.nstates
            zeros_ct = jnp.zeros((1, n), problem.atol.dtype)
            grad_p = backward_pass(
                problem, bwd_solver_cls, table, ev, t_eval, zeros_ct, params,
                bwd_max_steps, ct_g=ct_g,
            )
            return (grad_p,)
    else:
        K = int(checkpoint_interval)

        @jax.custom_vjp
        def g_of(params):
            _ys, g, _ck, _ev, _st = forward_with_checkpoints(
                solver, t_eval, params, max_steps, K, max_events
            )
            return g

        def fwd(params):
            _ys, g, ckpts, ev, _st = forward_with_checkpoints(
                solver, t_eval, params, max_steps, K, max_events
            )
            return g, (params, ckpts, ev)

        def bwd(res, ct_g):
            params, ckpts, ev = res
            n = problem.eqn.nstates
            zeros_ct = jnp.zeros((1, n), problem.atol.dtype)
            grad_p = backward_pass_bounded(
                problem, bwd_solver_cls, solver, ckpts, ev, t_eval, zeros_ct,
                params, bwd_max_steps, K, ct_g=ct_g,
            )
            return (grad_p,)

    g_of.defvjp(fwd, bwd)
    return g_of
