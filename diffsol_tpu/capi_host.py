"""Python side of the C ABI (reference crates/diffsol-c/src/ode.rs OdeWrapper).

The native shared library (native/capi.cpp) embeds CPython and drives this
module: each ``diffsol_ode_*`` C function maps to one function here, keyed
by an integer handle.  The wrapper erases the solver/tableau generics
behind runtime enums exactly like the reference's `OdeWrapper`
(diffsol-c/src/lib.rs:1-110): models arrive as DiffSL text
(`diffsol_ode_new_jit`), settings mutate a config that lazily rebuilds the
problem, and solves return flat float lists the C side copies out.

Data crosses the boundary as plain Python floats/lists -- the arrays at
this boundary are solver outputs (neval x nstates), small next to the
device-side work, matching the reference's HostArray copy-out semantics
(host_array_c.rs).
"""

from __future__ import annotations

import itertools
import os
import threading

import jax

# The C ABI is f64; embedded interpreters have no conftest to set this.
jax.config.update("jax_enable_x64", True)
if os.environ.get("DIFFSOL_PLATFORM"):
    # pins the embedded interpreter's backend (e.g. "cpu")
    jax.config.update("jax_platforms", os.environ["DIFFSOL_PLATFORM"])

import jax.numpy as jnp
import numpy as np

from . import errors
from .drivers import solve as _solve
from .drivers import solve_dense as _solve_dense
from .problem import OdeBuilder

# reference diffsol-c/src/ode_solver_type.rs:34-39 (same order)
_METHODS = ("bdf", "esdirk34", "tr_bdf2", "tsit45")
# reference diffsol-c/src/linear_solver_type.rs:15-19
_LINEAR_SOLVERS = ("default", "lu", "klu")
# reference diffsol-c/src/scalar_type.rs:11-14
_SCALARS = ("f32", "f64")

_registry: dict[int, "_OdeHandle"] = {}
_next_id = itertools.count(1)
_lock = threading.Lock()


class _OdeHandle:
    def __init__(self, code: str, model=None):
        self.code = code
        self.model = model  # compiled DiffslModel (for param-count checks)
        self.rtol = 1e-6
        self.atol = 1e-6
        self.t0 = 0.0
        self.h0 = 0.0
        self.params = None  # None => DiffSL in_i defaults
        self.method = 0  # bdf
        self.linear_solver = 0  # default
        self.scalar_type = 1  # f64 (the C data boundary is always double)
        self.integrate_out = False
        # optional tolerance groups (None = unset; reference ode_c.rs
        # sens/out/param rtol/atol get/setters)
        self.sens_rtol = None
        self.sens_atol = None
        self.out_rtol = None
        self.out_atol = None
        self.param_rtol = None
        self.param_atol = None
        # solver-wide + consistent-IC option overrides (reference
        # ode_options_c.rs / initial_condition_options_c.rs field surface)
        self.options = {}
        self.ic_options = {}
        self._problem = None
        self._solver = None

    def invalidate(self):
        self._problem = None
        self._solver = None
        self._adjoint_cache = None

    def problem(self):
        if self._problem is None:
            import dataclasses

            from .problem import InitialConditionOptions, OdeSolverOptions

            b = (
                OdeBuilder()
                .rtol(self.rtol)
                .atol(self.atol)
                .t0(self.t0)
                .h0(self.h0)
                .integrate_out(self.integrate_out)
            )
            for name in ("sens_rtol", "sens_atol", "out_rtol", "out_atol",
                         "param_rtol", "param_atol"):
                v = getattr(self, name)
                if v is not None:
                    b = getattr(b, name)(v)
            if self.options:
                b = b.options(
                    dataclasses.replace(OdeSolverOptions(), **self.options)
                )
            if self.ic_options:
                b = b.ic_options(
                    dataclasses.replace(
                        InitialConditionOptions(), **self.ic_options
                    )
                )
            if _LINEAR_SOLVERS[self.linear_solver] == "lu":
                b = b.linear_solver("dense")  # explicit dense LU tier
            if _SCALARS[self.scalar_type] == "f32":
                b = b.dtype(jnp.float32)
            if self.params is not None:
                b = b.p(self.params)
            self._problem = b.build_from_diffsl(self.code)
        return self._problem

    def solver(self):
        if self._solver is None:
            from .factory import solver as make_solver

            self._solver = make_solver(self.problem(), _METHODS[self.method])
        return self._solver


def _get(handle: int) -> _OdeHandle:
    h = _registry.get(handle)
    if h is None:
        raise KeyError(f"invalid ode handle {handle}")
    return h


# ---- lifecycle -----------------------------------------------------------


def new_jit(code: str) -> int:
    """diffsol_ode_new_jit (ode_c.rs:284): build from DiffSL text.

    Parse errors surface here (at create time), like the reference's JIT
    compile step.
    """
    from .diffsl import compile_diffsl

    model = compile_diffsl(code)  # validate eagerly
    h = _OdeHandle(code, model)
    with _lock:
        hid = next(_next_id)
        _registry[hid] = h
    return hid


def free(handle: int) -> None:
    with _lock:
        _registry.pop(handle, None)


def clear_caches() -> None:
    """Drop jax's in-memory executable caches (a long-lived embedding
    process that builds many models accumulates live compiled whole-solve
    executables; the XLA CPU compiler is known to crash once the live set
    grows unboundedly -- see tests/conftest.py).  Solver handles stay
    valid: their programs recompile lazily (cheaply, via the persistent
    on-disk compilation cache when configured)."""
    import jax

    jax.clear_caches()


# ---- settings ------------------------------------------------------------


def set_rtol(handle, v):
    h = _get(handle)
    h.rtol = float(v)
    h.invalidate()


def get_rtol(handle):
    return float(_get(handle).rtol)


def set_atol(handle, v):
    h = _get(handle)
    h.atol = float(v)
    h.invalidate()


def get_atol(handle):
    return float(_get(handle).atol)


def set_t0(handle, v):
    h = _get(handle)
    h.t0 = float(v)
    h.invalidate()


def get_t0(handle):
    return float(_get(handle).t0)


def set_h0(handle, v):
    h = _get(handle)
    h.h0 = float(v)
    h.invalidate()


def get_h0(handle):
    return float(_get(handle).h0)


def set_params(handle, values):
    h = _get(handle)
    vals = [float(v) for v in values]
    if h.model is not None and len(vals) != len(h.model.default_params):
        raise ValueError(
            f"model declares {len(h.model.default_params)} inputs (in_i) "
            f"but set_params supplied {len(vals)}"
        )
    h.params = vals
    h.invalidate()


def get_params(handle):
    h = _get(handle)
    if h.params is not None:
        return list(h.params)
    return [float(v) for v in np.asarray(h.problem().params)]


def set_ode_solver(handle, value):
    value = int(value)
    if not 0 <= value < len(_METHODS):
        raise ValueError(f"invalid ode solver type {value}")
    h = _get(handle)
    h.method = value
    h._solver = None


def get_ode_solver(handle):
    return int(_get(handle).method)


def set_linear_solver(handle, value):
    value = int(value)
    if not 0 <= value < len(_LINEAR_SOLVERS):
        raise ValueError(f"invalid linear solver type {value}")
    if _LINEAR_SOLVERS[value] == "klu":
        raise ValueError(
            "klu is a CPU/SuiteSparse solver; this build provides "
            "dense/banded tiers (use 'default' or 'lu')"
        )
    h = _get(handle)
    h.linear_solver = value
    h.invalidate()


def get_linear_solver(handle):
    return int(_get(handle).linear_solver)


def set_scalar_type(handle, value):
    value = int(value)
    if not 0 <= value < len(_SCALARS):
        raise ValueError(f"invalid scalar type {value}")
    h = _get(handle)
    h.scalar_type = value
    h.invalidate()


def get_scalar_type(handle):
    return int(_get(handle).scalar_type)


def set_integrate_out(handle, value):
    h = _get(handle)
    h.integrate_out = bool(value)
    h.invalidate()


def get_integrate_out(handle):
    return int(_get(handle).integrate_out)


# ---- introspection -------------------------------------------------------


def nstates(handle):
    return int(_get(handle).problem().eqn.nstates)


def nparams(handle):
    return int(_get(handle).problem().eqn.nparams)


def nout(handle):
    p = _get(handle).problem()
    return int(p.eqn.nout if p.eqn.out is not None else p.eqn.nstates)


# ---- op evaluation (ode_c.rs:389-511) -------------------------------------


def y0(handle):
    p = _get(handle).problem()
    arr = p.eqn.init(jnp.asarray(p.t0), p.params)
    return [float(v) for v in np.asarray(arr)]


def rhs(handle, t, y):
    p = _get(handle).problem()
    arr = p.eqn.rhs(
        jnp.asarray(float(t)), jnp.asarray([float(v) for v in y]), p.params
    )
    return [float(v) for v in np.asarray(arr)]


def rhs_jac_mul(handle, t, y, v):
    p = _get(handle).problem()
    arr = p.eqn.jac_mul(
        jnp.asarray(float(t)),
        jnp.asarray([float(x) for x in y]),
        p.params,
        jnp.asarray([float(x) for x in v]),
    )
    return [float(x) for x in np.asarray(arr)]


# ---- solves (ode_c.rs:512-623, solve.rs) ----------------------------------


def solve(handle, t_final, max_steps=10_000):
    """Adaptive solve; returns (ts, ys_flat_row_major, npoints, stop)."""
    h = _get(handle)
    sol = _solve(h.solver(), float(t_final), max_steps=int(max_steps))
    npts = int(sol.n_points)
    ts = np.asarray(sol.ts[:npts])
    ys = np.asarray(sol.ys[:npts])
    return (
        [float(v) for v in ts],
        [float(v) for v in ys.reshape(-1)],
        npts,
        int(sol.stop_reason),
    )


def solve_dense(handle, t_eval, max_steps=10_000):
    """Dense-output solve; returns (ys_flat_row_major, stop_reason)."""
    h = _get(handle)
    sol = _solve_dense(
        h.solver(),
        jnp.asarray([float(t) for t in t_eval]),
        max_steps=int(max_steps),
    )
    ys = np.asarray(sol.ys)
    return [float(v) for v in ys.reshape(-1)], int(sol.stop_reason)


def solve_fwd_sens(handle, t_eval, max_steps=10_000):
    """Forward sensitivities; returns (ys_flat, sens_flat[np, neval, n],
    stop_reason)."""
    from .sens import solve_dense_fwd_sens

    h = _get(handle)
    ys, sens = solve_dense_fwd_sens(
        h.solver(), jnp.asarray([float(t) for t in t_eval])
    )
    return (
        [float(v) for v in np.asarray(ys).reshape(-1)],
        [float(v) for v in np.asarray(sens).reshape(-1)],
        0,
    )


def solve_adjoint(handle, t_eval, dgdu, max_steps=16_384):
    """Adjoint gradient (reference solve.rs:123-146 solve_adjoint_fwd +
    solve_adjoint_bkwd collapsed into one call): given dG/du at the eval
    points (flat, neval * nstates), returns (ys_flat, dG/dp).
    """
    import functools

    from .adjoint import make_differentiable_solve
    from .solvers.bdf import BdfSolver
    from .solvers.erk import ErkSolver
    from .solvers.sdirk import SdirkSolver
    from .solvers.tableau import esdirk34, tr_bdf2

    h = _get(handle)
    problem = h.problem()
    t = jnp.asarray([float(x) for x in t_eval])
    n = int(problem.eqn.nstates)
    ct = jnp.asarray([float(x) for x in dgdu]).reshape(t.shape[0], n)
    cls = {
        0: BdfSolver,
        1: functools.partial(SdirkSolver, tableau=esdirk34()),
        2: functools.partial(SdirkSolver, tableau=tr_bdf2()),
        3: ErkSolver,
    }[h.method]
    # the cache is cleared by invalidate() on every settings change, so a
    # cached fn never closes over a stale problem
    key = (tuple(float(x) for x in t_eval), int(max_steps), h.method)
    cache = getattr(h, "_adjoint_cache", None)
    if cache is None or cache[0] != key:
        fn = make_differentiable_solve(
            problem, t, solver_cls=cls, max_steps=int(max_steps)
        )
        h._adjoint_cache = (key, fn)
    fn = h._adjoint_cache[1]
    ys, vjp = jax.vjp(fn, jnp.asarray(problem.params))
    grad = vjp(ct)[0]
    return (
        [float(v) for v in np.asarray(ys).reshape(-1)],
        [float(v) for v in np.asarray(grad)],
    )


def stop_reason_name(code):
    return errors._MESSAGES.get(int(code), "ok")


# ---- optional tolerance groups (ode_c.rs sens/out/param get/setters) ------
# get returns NaN when unset; setting NaN clears the group (the reference
# errors on unconfigured getters; NaN-signalling keeps the C ABI one-call).


def _tol_set(name):
    def setter(handle, v):
        h = _get(handle)
        v = float(v)
        setattr(h, name, None if v != v else v)  # NaN clears
        h.invalidate()

    return setter


def _tol_get(name):
    def getter(handle):
        v = getattr(_get(handle), name)
        return float("nan") if v is None else float(v)

    return getter


set_sens_rtol = _tol_set("sens_rtol")
get_sens_rtol = _tol_get("sens_rtol")
set_sens_atol = _tol_set("sens_atol")
get_sens_atol = _tol_get("sens_atol")
set_out_rtol = _tol_set("out_rtol")
get_out_rtol = _tol_get("out_rtol")
set_out_atol = _tol_set("out_atol")
get_out_atol = _tol_get("out_atol")
set_param_rtol = _tol_set("param_rtol")
get_param_rtol = _tol_get("param_rtol")
set_param_atol = _tol_set("param_atol")
get_param_atol = _tol_get("param_atol")


# ---- solver options / IC options field surface ----------------------------
# The reference exposes options OBJECTS that read/write through to the live
# solve (ode_options.rs Arc-backed get/setters).  Here the C side holds the
# ode handle and routes per-field calls; the dict overlays the defaults of
# problem.OdeSolverOptions / InitialConditionOptions.

_OPTION_FIELDS = {
    # name -> (python type, reference ode_options_c.rs field)
    "max_nonlinear_solver_iterations": int,
    "max_error_test_failures": int,
    "max_nonlinear_solver_failures": int,
    "update_jacobian_after_steps": int,
    "update_rhs_jacobian_after_steps": int,
    "threshold_to_update_jacobian": float,
    "threshold_to_update_rhs_jacobian": float,
    "min_timestep": float,
}
_IC_OPTION_FIELDS = {
    "use_linesearch": bool,
    "max_linesearch_iterations": int,
    "max_newton_iterations": int,
    "max_linear_solver_setups": int,
    "step_reduction_factor": float,
    "armijo_constant": float,
}


def options_set(handle, name, value):
    h = _get(handle)
    ty = _OPTION_FIELDS.get(name)
    if ty is None:
        raise ValueError(f"unknown solver option {name!r}")
    h.options[name] = ty(value)
    h.invalidate()


def options_get(handle, name):
    h = _get(handle)
    if name not in _OPTION_FIELDS:
        raise ValueError(f"unknown solver option {name!r}")
    from .problem import OdeSolverOptions

    v = h.options.get(name, getattr(OdeSolverOptions(), name))
    return float(v)


def ic_options_set(handle, name, value):
    h = _get(handle)
    ty = _IC_OPTION_FIELDS.get(name)
    if ty is None:
        raise ValueError(f"unknown ic option {name!r}")
    h.ic_options[name] = ty(value)
    h.invalidate()


def ic_options_get(handle, name):
    h = _get(handle)
    if name not in _IC_OPTION_FIELDS:
        raise ValueError(f"unknown ic option {name!r}")
    from .problem import InitialConditionOptions

    v = h.ic_options.get(name, getattr(InitialConditionOptions(), name))
    return float(v)


# ---- quadrature-output solve (reference integrate_out solve surface) ------


def solve_dense_out(handle, t_eval, max_steps=10_000):
    """Dense-output solve returning the integrated outputs g(t_i)
    (requires set_integrate_out(1)); (gs_flat_row_major, nout, stop)."""
    h = _get(handle)
    p = h.problem()
    if not p.integrate_out:
        raise ValueError("solve_dense_out requires integrate_out")
    sol = _solve_dense(
        h.solver(),
        jnp.asarray([float(t) for t in t_eval]),
        max_steps=int(max_steps),
    )
    gs = np.asarray(sol.gs)
    return (
        [float(v) for v in gs.reshape(-1)],
        int(gs.shape[-1]),
        int(sol.stop_reason),
    )


# ---- type-enumeration helpers (reference *_type_count/name/is_valid) ------

# matrix tiers: this build's containers are jnp arrays; the role of the
# reference's NalgebraDense/FaerDense/FaerSparse enum is played by the
# linear-solver tier layout (matrix_type_c.rs)
_MATRIX_TYPES = ("dense", "banded", "blockdiag", "matrix_free")
# the JIT "backend" is XLA itself (jit.rs LlvmModule/CraneliftModule)
_JIT_BACKENDS = ("xla",)

_TYPE_TABLES = {
    "ode_solver": _METHODS,
    "linear_solver": _LINEAR_SOLVERS,
    "scalar": _SCALARS,
    "matrix": _MATRIX_TYPES,
    "jit_backend": _JIT_BACKENDS,
}


def type_count(kind):
    return len(_TYPE_TABLES[kind])


def type_name(kind, value):
    table = _TYPE_TABLES[kind]
    value = int(value)
    if not 0 <= value < len(table):
        raise ValueError(f"invalid {kind} type {value}")
    return table[value]


def type_is_valid(kind, value):
    return int(0 <= int(value) < len(_TYPE_TABLES[kind]))


# ---- matrix-type introspection (reference ode_c.rs:624
# diffsol_ode_get_matrix_type) ----------------------------------------------


def get_matrix_type(handle):
    """The tier-layout enum index of the BUILT problem's linear solver
    (reference maps the OdeWrapper's matrix backend to MatrixType;
    here the analogous runtime fact is which solver tier the auto-router
    or the user selected)."""
    p = _get(handle).problem()
    name = p.linear_solver.name
    if name.startswith("banded") or name.startswith("pallas_banded"):
        return _MATRIX_TYPES.index("banded")
    if name.startswith("blockdiag"):
        return _MATRIX_TYPES.index("blockdiag")
    if name.startswith("krylov"):
        return _MATRIX_TYPES.index("matrix_free")
    return _MATRIX_TYPES.index("dense")


# ---- external model loading (reference solve.rs:324 new_external /
# new_external_dynamic: dlopen a precompiled DiffSL cdylib.  The
# embedded-CPython analog of a "dynamic model artifact" is a Python module
# file defining the model callables.) ---------------------------------------


class _ExternalHandle(_OdeHandle):
    def __init__(self, mod):
        super().__init__(code=None, model=None)
        self.external = mod
        if hasattr(mod, "params"):
            self.params = [float(v) for v in mod.params]

    def problem(self):
        if self._problem is None:
            import dataclasses

            from .problem import InitialConditionOptions, OdeSolverOptions

            mod = self.external
            b = (
                OdeBuilder()
                .rtol(self.rtol)
                .atol(self.atol)
                .t0(self.t0)
                .h0(self.h0)
                .integrate_out(self.integrate_out)
                .rhs(mod.rhs)
                .init(mod.init)
            )
            for name in ("mass", "root", "out", "reset"):
                if hasattr(mod, name):
                    b = getattr(b, name)(getattr(mod, name))
            for name in ("sens_rtol", "sens_atol", "out_rtol", "out_atol",
                         "param_rtol", "param_atol"):
                v = getattr(self, name)
                if v is not None:
                    b = getattr(b, name)(v)
            if self.options:
                b = b.options(
                    dataclasses.replace(OdeSolverOptions(), **self.options)
                )
            if self.ic_options:
                b = b.ic_options(
                    dataclasses.replace(
                        InitialConditionOptions(), **self.ic_options
                    )
                )
            if _LINEAR_SOLVERS[self.linear_solver] == "lu":
                b = b.linear_solver("dense")
            if _SCALARS[self.scalar_type] == "f32":
                b = b.dtype(jnp.float32)
            if self.params is not None:
                b = b.p(self.params)
            if getattr(mod, "use_coloring", False):
                b = b.use_coloring()
            self._problem = b.build()
        return self._problem


def new_external_dynamic(path):
    """Load a model from an external Python module file (the dynamic-model
    analog: the reference dlopens a DiffSL cdylib, solve.rs:324; an
    embedded-CPython host loads a .py defining rhs(t,y,p), init(t,p) and
    optional mass/root/reset/out/params/use_coloring)."""
    import importlib.util
    import os

    base = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"_diffsol_ext_{base}", path)
    if spec is None or spec.loader is None:
        raise ValueError(f"cannot load external model at {path!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for req in ("rhs", "init"):
        if not hasattr(mod, req):
            raise ValueError(
                f"external model {path!r} does not define {req}(...)"
            )
    h = _ExternalHandle(mod)
    with _lock:
        hid = next(_next_id)
        _registry[hid] = h
    return hid


# ---- solution-wrapper solves (reference solution_wrapper_c.rs: solve
# results owned by a handle; ys/ts/sens materialize as host arrays) ---------


def solve_solution(handle, t_eval, max_steps=10_000, with_sens=0):
    """Dense-output solve returning (ts, ys_flat[neval*n], nstates,
    sens_flat_list[np][neval*n], stop) for the solution-wrapper surface."""
    h = _get(handle)
    te = [float(t) for t in t_eval]
    sens_list = []
    if int(with_sens):
        from .sens import solve_dense_fwd_sens

        ys, sens = solve_dense_fwd_sens(h.solver(), jnp.asarray(te))
        sens_np = np.asarray(sens)  # (np, neval, n)
        sens_list = [
            [float(v) for v in sens_np[i].reshape(-1)]
            for i in range(sens_np.shape[0])
        ]
        stop = 0
        ys_np = np.asarray(ys)
    else:
        sol = _solve_dense(
            h.solver(), jnp.asarray(te), max_steps=int(max_steps)
        )
        ys_np = np.asarray(sol.ys)
        stop = int(sol.stop_reason)
    return (
        te,
        [float(v) for v in ys_np.reshape(-1)],
        int(ys_np.shape[-1]),
        sens_list,
        stop,
    )
