"""Solve drivers: full solves as single jitted while-loops.

Equivalent of the reference driver functions on `OdeSolverMethod`
(reference crates/diffsol/src/ode_solver/method.rs:721-818 `solve_dense`,
:881-961 `solve`), including the root/reset protocol: on RootFound the state
is pinned back to the root time via the dense-output interpolant
(`state_mut_back`), the reset operator is applied if present and the solve
auto-continues; without a reset operator the solve stops at the root
(method.rs:774-805, lib.rs:194-213).

Design: instead of growth-doubling output buffers, outputs are written
into preallocated fixed-shape buffers inside one ``lax.while_loop``; for
``solve_dense`` each accepted step interpolates ALL t_eval points and writes
the ones falling inside the step with a mask (vectorized equivalent of the
reference's `while col < t_eval.len() && t_eval[col] <= t` loop).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from . import errors
from ._pytree import pytree_dataclass
from .precision import highest_precision


@pytree_dataclass(static=("tier",))
class Solution:
    """Solve result (reference `Solution`, solution.rs:70-221).

    ``ts``/``ys`` hold the output points; for adaptive ``solve`` only the
    first ``n_points`` entries are valid.  ``stop_reason`` is an
    :mod:`diffsol_tpu.errors` code; ``state`` is the final solver state
    (restartable checkpoint, reference method.rs:56-70).

    ``tier`` records which execution path produced an ensemble solve
    (``"lockstep"``/``"independent"``; ``None`` for single-instance
    drivers).
    """

    ts: jax.Array
    ys: jax.Array
    gs: Optional[jax.Array]
    sens: Optional[jax.Array]
    stop_reason: jax.Array
    n_points: jax.Array
    root_t: jax.Array
    root_idx: jax.Array
    state: Any
    tier: Optional[str] = None

    def raise_for_status(self):
        errors.check_status(int(self.stop_reason), float(self.state.t))
        return self


def init_state_jit(solver, params):
    """Jit-compiled ``solver.init_state`` (cached per solver).

    Eager init dispatches hundreds of individual ops, one host round trip
    each, so every driver initializes through this wrapper.
    """
    fn = _get_cached(solver, "_init_state_jit", lambda: jax.jit(solver.init_state))
    return fn(params)


def _pin_to(solver, state, t):
    """state_mut_back: move the state back to time t inside the last step."""
    y = solver.interpolate(state, t)
    dy = solver.interpolate_dy(state, t)
    upd = dict(y=y, dy=dy, t=t, state_modified=jnp.asarray(True))
    if solver.problem.integrate_out:
        upd["g"] = solver.interpolate_out(state, t)
    if getattr(state, "s", None) is not None:
        upd["s"] = solver.interpolate_sens(state, t)
    return state.replace(**upd)


def _apply_reset(solver, state, params):
    """Apply the reset operator R(t, y) and refresh dy (reference
    state.rs:246-320 apply_reset / apply_reset_with_mass); augmented rows
    (continuous sensitivities) get the event-jump correction
    (state.rs:308-560 apply_reset_with_sens)."""
    p = solver.problem
    y_minus, dy_minus = state.y, state.dy
    s_minus = getattr(state, "s", None)
    if p.eqn.reset_n is not None:
        # index-aware reset: N = the root that fired (reference
        # set_model_index(root_idx) before apply_reset)
        y_new = p.eqn.reset_n(state.t, state.y, params, state.root_idx)
    else:
        y_new = p.eqn.reset(state.t, state.y, params)
    state = state.replace(y=y_new, state_modified=jnp.asarray(True))
    if hasattr(solver, "reinit_after_reset"):
        state = solver.reinit_after_reset(state, params)
    else:
        dy_new = p.eqn.rhs(state.t, y_new, params)
        state = state.replace(dy=dy_new)
    aug = getattr(solver, "aug", None)
    if aug is not None and s_minus is not None:
        s_plus = aug.apply_reset(
            state.t, y_minus, dy_minus, state.y, state.dy, params,
            s_minus, state.root_idx,
        )
        state = state.replace(s=s_plus)
    return state


def solve_dense(solver, t_eval, params=None, state=None, max_steps: int = 100_000):
    """Solve and interpolate the solution onto ``t_eval`` (ascending).

    Returns a :class:`Solution` with ``ys`` of shape (len(t_eval), nstates).
    """
    p = solver.problem
    params = p.params if params is None else params
    if state is None:
        # fold init into the solve program: one device dispatch total
        # (a separate init call costs a full host<->device round trip)
        inner = _get_cached(
            solver,
            f"_solve_dense_jit_{max_steps}",
            lambda: _make_solve_dense(solver, max_steps),
        )

        def init_and_solve(params, t_eval):
            st = solver.init_state(params)
            return inner(st, params, jnp.asarray(t_eval, st.t.dtype))

        fn = _get_cached(
            solver,
            f"_solve_dense_init_jit_{max_steps}",
            lambda: jax.jit(init_and_solve),
        )
        return fn(params, jnp.asarray(t_eval))
    t_eval = jnp.asarray(t_eval, state.t.dtype)

    fn = _get_cached(solver, f"_solve_dense_jit_{max_steps}", lambda: _make_solve_dense(solver, max_steps))
    return fn(state, params, t_eval)


def _make_solve_dense(solver, max_steps):
    p = solver.problem
    has_root = p.eqn.root is not None
    has_reset = p.eqn.reset is not None
    integrate_out = p.integrate_out
    has_sens = getattr(solver, "has_sens", False)
    # reference parity (method.rs:965-999): with an `out` function but no
    # quadrature, the output columns are out(t, y)
    out_direct = (p.eqn.out is not None) and not integrate_out

    @highest_precision
    def impl(state, params, t_eval):
        neval = t_eval.shape[0]
        final_time = t_eval[-1]
        state = solver.set_stop_time(state, final_time)
        n = state.y.shape[-1]
        dtype = state.y.dtype
        ys = jnp.zeros((neval,) + state.y.shape, dtype)
        if integrate_out:
            gs = jnp.zeros((neval,) + state.g.shape, dtype)
        elif out_direct:
            out_shape = jax.eval_shape(
                p.eqn.out, state.t, state.y, params
            ).shape
            gs = jnp.zeros((neval,) + out_shape, dtype)
        else:
            gs = None
        ss = (
            jnp.zeros((neval,) + state.s.shape, dtype) if has_sens else None
        )

        def write(state_new, t_upper, written_to, ys, gs, ss):
            mask = (t_eval <= t_upper) & (t_eval > written_to)

            def do_write(args):
                ys, gs, ss = args
                y_interp = jax.vmap(
                    lambda tt: solver.interpolate(state_new, tt)
                )(t_eval)
                ys = jnp.where(
                    mask.reshape((-1,) + (1,) * (ys.ndim - 1)), y_interp, ys
                )
                if integrate_out:
                    g_interp = jax.vmap(
                        lambda tt: solver.interpolate_out(state_new, tt)
                    )(t_eval)
                    gs = jnp.where(
                        mask.reshape((-1,) + (1,) * (gs.ndim - 1)), g_interp, gs
                    )
                if out_direct:
                    g_interp = jax.vmap(
                        lambda tt: p.eqn.out(
                            tt, solver.interpolate(state_new, tt), params
                        )
                    )(t_eval)
                    gs = jnp.where(
                        mask.reshape((-1,) + (1,) * (gs.ndim - 1)), g_interp, gs
                    )
                if has_sens:
                    s_interp = jax.vmap(
                        lambda tt: solver.interpolate_sens(state_new, tt)
                    )(t_eval)
                    ss = jnp.where(
                        mask.reshape((-1,) + (1,) * (ss.ndim - 1)), s_interp, ss
                    )
                return ys, gs, ss

            # most steps bracket no output point: skip the interpolation work
            return jax.lax.cond(
                jnp.any(mask), do_write, lambda args: args, (ys, gs, ss)
            )

        def cond(carry):
            (_state, _ys, _gs, _ss, _written_to, done, k, _stop, _rt, _ri) = carry
            return (~done) & (k < max_steps)

        def body(carry):
            (state, ys, gs, ss, written_to, _done, k, stop, root_t, root_idx) = carry
            new = solver.step(state, params)
            status = new.status
            fatal = status < 0
            is_root = status == errors.ROOT_FOUND
            is_tstop = status == errors.TSTOP_REACHED

            t_upper = jnp.where(is_root, new.root_t, new.t)
            # the tstop-landing step may undershoot final_time by roundoff;
            # extend the write interval to cover the last t_eval point
            t_upper = jnp.where(is_tstop, jnp.maximum(t_upper, final_time), t_upper)
            t_upper = jnp.where(fatal, written_to, t_upper)
            ys, gs, ss = write(new, t_upper, written_to, ys, gs, ss)

            if has_root and has_reset:
                def on_root(s):
                    pinned = _pin_to(solver, s, s.root_t)
                    return _apply_reset(solver, pinned, params)

                new = jax.lax.cond(is_root, on_root, lambda s: s, new)
                root_done = is_root & (new.t >= final_time)
                done = fatal | is_tstop | root_done
                stop = jnp.where(
                    is_tstop | root_done,
                    errors.TSTOP_REACHED,
                    jnp.where(fatal, status, stop),
                ).astype(jnp.int32)
            elif has_root:
                def on_root(s):
                    return _pin_to(solver, s, s.root_t)

                new = jax.lax.cond(is_root, on_root, lambda s: s, new)
                done = fatal | is_tstop | is_root
                stop = jnp.where(
                    is_root,
                    errors.ROOT_FOUND,
                    jnp.where(
                        is_tstop, errors.TSTOP_REACHED, jnp.where(fatal, status, stop)
                    ),
                ).astype(jnp.int32)
                root_t = jnp.where(is_root, new.t, root_t)
                root_idx = jnp.where(is_root, new.root_idx, root_idx)
            else:
                # no root function: the pin/reset machinery is not emitted
                done = fatal | is_tstop
                stop = jnp.where(
                    is_tstop, errors.TSTOP_REACHED, jnp.where(fatal, status, stop)
                ).astype(jnp.int32)

            return (new, ys, gs, ss, t_upper, done, k + 1, stop, root_t, root_idx)

        init_failed = state.status < 0
        init = (
            state, ys, gs, ss,
            jnp.asarray(-jnp.inf, dtype),
            init_failed,
            jnp.asarray(0, jnp.int32),
            jnp.where(init_failed, state.status, errors.TSTOP_REACHED).astype(
                jnp.int32
            ),
            jnp.asarray(jnp.nan, dtype),
            jnp.asarray(-1, jnp.int32),
        )
        (state, ys, gs, ss, _w, done, k, stop, root_t, root_idx) = (
            jax.lax.while_loop(cond, body, init)
        )
        stop = jnp.where(done, stop, errors.MAX_STEPS_REACHED).astype(jnp.int32)
        return Solution(
            ts=t_eval, ys=ys, gs=gs, sens=ss, stop_reason=stop,
            n_points=jnp.asarray(t_eval.shape[0], jnp.int32),
            root_t=root_t, root_idx=root_idx, state=state,
        )

    return jax.jit(impl)


def solve(solver, final_time, params=None, state=None, max_steps: int = 10_000):
    """Adaptive solve to ``final_time``, recording every internal step.

    Returns a :class:`Solution` whose ``ts``/``ys`` buffers have
    ``max_steps + 2`` rows; the first ``n_points`` are valid.
    """
    p = solver.problem
    params = p.params if params is None else params
    if state is None:
        state = init_state_jit(solver, params)
    final_time = jnp.asarray(final_time, state.t.dtype)

    fn = _get_cached(solver, f"_solve_jit_{max_steps}", lambda: _make_solve(solver, max_steps))
    return fn(state, params, final_time)


def _make_solve(solver, max_steps):
    p = solver.problem
    has_root = p.eqn.root is not None
    has_reset = p.eqn.reset is not None
    integrate_out = p.integrate_out
    has_sens = getattr(solver, "has_sens", False)
    out_direct = (p.eqn.out is not None) and not integrate_out
    nbuf = max_steps + 2

    @highest_precision
    def impl(state, params, final_time):
        dtype = state.y.dtype
        ts = jnp.full((nbuf,), jnp.nan, dtype)
        ys = jnp.zeros((nbuf,) + state.y.shape, dtype)
        if integrate_out:
            gs = jnp.zeros((nbuf,) + state.g.shape, dtype)
        elif out_direct:
            out_shape = jax.eval_shape(
                p.eqn.out, state.t, state.y, params
            ).shape
            gs = jnp.zeros((nbuf,) + out_shape, dtype)
        else:
            gs = None
        ss = jnp.zeros((nbuf,) + state.s.shape, dtype) if has_sens else None

        def write(ts, ys, gs, ss, k, state):
            ts = ts.at[k].set(state.t)
            ys = ys.at[k].set(state.y)
            if integrate_out:
                gs = gs.at[k].set(state.g)
            elif out_direct:
                gs = gs.at[k].set(p.eqn.out(state.t, state.y, params))
            if has_sens:
                ss = ss.at[k].set(state.s)
            return ts, ys, gs, ss, k + 1

        ts, ys, gs, ss, k0 = write(ts, ys, gs, ss, jnp.asarray(0, jnp.int32), state)
        state = solver.set_stop_time(state, final_time)

        def cond(carry):
            (_state, _ts, _ys, _gs, _ss, _k, done, nsteps, _stop, _rt, _ri) = carry
            return (~done) & (nsteps < max_steps)

        def body(carry):
            (state, ts, ys, gs, ss, k, _done, nsteps, stop, root_t, root_idx) = carry
            new = solver.step(state, params)
            status = new.status
            fatal = status < 0
            is_root = status == errors.ROOT_FOUND
            is_tstop = status == errors.TSTOP_REACHED

            if has_root and has_reset:
                def on_root(s):
                    pinned = _pin_to(solver, s, s.root_t)
                    return _apply_reset(solver, pinned, params)

                new = jax.lax.cond(is_root, on_root, lambda s: s, new)
                root_done = is_root & (new.t >= final_time)
                done = fatal | is_tstop | root_done
                stop = jnp.where(
                    is_tstop | root_done,
                    errors.TSTOP_REACHED,
                    jnp.where(fatal, status, stop),
                ).astype(jnp.int32)
            elif has_root:
                def on_root(s):
                    return _pin_to(solver, s, s.root_t)

                new = jax.lax.cond(is_root, on_root, lambda s: s, new)
                done = fatal | is_tstop | is_root
                stop = jnp.where(
                    is_root,
                    errors.ROOT_FOUND,
                    jnp.where(
                        is_tstop, errors.TSTOP_REACHED, jnp.where(fatal, status, stop)
                    ),
                ).astype(jnp.int32)
                root_t = jnp.where(is_root, new.t, root_t)
                root_idx = jnp.where(is_root, new.root_idx, root_idx)
            else:
                done = fatal | is_tstop
                stop = jnp.where(
                    is_tstop, errors.TSTOP_REACHED, jnp.where(fatal, status, stop)
                ).astype(jnp.int32)

            ts, ys, gs, ss, k = jax.lax.cond(
                fatal,
                lambda args: args,
                lambda args: write(*args[:5], new),
                (ts, ys, gs, ss, k),
            )
            return (new, ts, ys, gs, ss, k, done, nsteps + 1, stop, root_t, root_idx)

        init_failed = state.status < 0
        init = (
            state, ts, ys, gs, ss, k0,
            init_failed,
            jnp.asarray(0, jnp.int32),
            jnp.where(init_failed, state.status, errors.TSTOP_REACHED).astype(
                jnp.int32
            ),
            jnp.asarray(jnp.nan, dtype),
            jnp.asarray(-1, jnp.int32),
        )
        (state, ts, ys, gs, ss, k, done, _n, stop, root_t, root_idx) = (
            jax.lax.while_loop(cond, body, init)
        )
        stop = jnp.where(done, stop, errors.MAX_STEPS_REACHED).astype(jnp.int32)
        return Solution(
            ts=ts, ys=ys, gs=gs, sens=ss, stop_reason=stop, n_points=k,
            root_t=root_t, root_idx=root_idx, state=state,
        )

    return jax.jit(impl)


def _get_cached(solver, attr, make_fn):
    cached = getattr(solver, attr, None)
    if cached is None:
        cached = make_fn()
        setattr(solver, attr, cached)
    return cached
