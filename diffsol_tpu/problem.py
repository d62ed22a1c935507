"""Problem definition, options and the fluent builder.

Equivalent of the reference problem/builder API (reference
crates/diffsol/src/ode_solver/builder.rs:112-1933 `OdeBuilder`,
problem.rs:98-152 `OdeSolverOptions`, problem.rs:15-43
`InitialConditionSolverOptions`, config.rs per-solver configs).  All defaults
match the reference.

An :class:`OdeProblem` is a registered pytree: the equation callables,
integer limits and solver policies are static metadata, while ``params``,
``t0``, ``h0`` and the tolerances are traced leaves -- ``vmap`` over
``params`` is the ensemble axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import jax.numpy as jnp

from ._pytree import pytree_dataclass
from .equations import OdeEquations, make_equations
from .ops.linsol import DENSE, LinearSolverSpec, get_solver


@dataclass(frozen=True)
class OdeSolverOptions:
    """Solver-wide policies (reference problem.rs:98-152, same defaults)."""

    max_nonlinear_solver_iterations: int = 10
    max_error_test_failures: int = 40
    max_nonlinear_solver_failures: int = 50
    nonlinear_solver_tolerance: float = 0.2
    min_timestep: float = 1e-13
    max_timestep_growth: Optional[float] = None  # solver-specific default
    min_timestep_growth: Optional[float] = None
    max_timestep_shrink: Optional[float] = None
    min_timestep_shrink: Optional[float] = None
    update_jacobian_after_steps: int = 20
    update_rhs_jacobian_after_steps: int = 50
    threshold_to_update_jacobian: float = 0.3
    threshold_to_update_rhs_jacobian: float = 0.2
    pi_control_proportional: float = 0.0
    pi_control_integral: float = 0.5


@dataclass(frozen=True)
class InitialConditionOptions:
    """Consistent-IC Newton options (reference problem.rs:15-43)."""

    use_linesearch: bool = True
    max_linesearch_iterations: int = 10
    max_newton_iterations: int = 10
    max_linear_solver_setups: int = 4
    step_reduction_factor: float = 0.5
    armijo_constant: float = 1e-4


@dataclass(frozen=True)
class SolverConfig:
    """Per-solver step-size clamps (reference config.rs:22-146).

    ``from_options`` applies the reference solver-specific defaults:
    BDF/SDIRK: growth in [2, 2], shrink dead-zone [0.5, 0.9];
    ERK: growth [1, 2], shrink [0.5, 1].
    """

    minimum_timestep: float = 1e-13
    maximum_error_test_failures: int = 40
    maximum_newton_fails: int = 50
    maximum_newton_iterations: int = 10
    maximum_timestep_growth: float = 2.0
    minimum_timestep_growth: float = 2.0
    maximum_timestep_shrink: float = 0.9
    minimum_timestep_shrink: float = 0.5

    @staticmethod
    def from_options(opts: OdeSolverOptions, kind: str) -> "SolverConfig":
        if kind == "erk":
            ming, maxs = 1.0, 1.0
        else:
            ming, maxs = 2.0, 0.9
        return SolverConfig(
            minimum_timestep=opts.min_timestep,
            maximum_error_test_failures=opts.max_error_test_failures,
            maximum_newton_fails=opts.max_nonlinear_solver_failures,
            maximum_newton_iterations=opts.max_nonlinear_solver_iterations,
            maximum_timestep_growth=(
                opts.max_timestep_growth if opts.max_timestep_growth is not None else 2.0
            ),
            minimum_timestep_growth=(
                opts.min_timestep_growth if opts.min_timestep_growth is not None else ming
            ),
            maximum_timestep_shrink=(
                opts.max_timestep_shrink if opts.max_timestep_shrink is not None else maxs
            ),
            minimum_timestep_shrink=(
                opts.min_timestep_shrink if opts.min_timestep_shrink is not None else 0.5
            ),
        )


@pytree_dataclass(
    static=(
        "eqn", "options", "ic_options", "integrate_out", "linear_solver",
        "lockstep_nbatch",
    )
)
class OdeProblem:
    """An ODE/DAE problem ready to be handed to a solver.

    Pytree leaves: ``params``, ``t0``, ``h0``, ``rtol``, ``atol`` (vector of
    length nstates) and the optional out/sens tolerance leaves.  Everything
    else is static.  (Reference `OdeSolverProblem`, problem.rs:161-240.)
    """

    eqn: OdeEquations
    params: Any
    t0: Any
    h0: Any
    rtol: Any
    atol: Any
    out_rtol: Any = None
    out_atol: Any = None
    sens_rtol: Any = None
    sens_atol: Any = None
    # adjoint parameter-gradient row tolerances (reference builder.rs:36-40
    # param_rtol/param_atol/param_scales; used by AdjointEquations,
    # adjoint_equations.rs:580-581)
    param_rtol: Any = None
    param_atol: Any = None
    param_scales: Any = None
    integrate_out: bool = False
    # >1 => the state is a FLAT lockstep ensemble of this many member
    # systems (see diffsol_tpu.ensemble); norms reduce mean-then-max
    lockstep_nbatch: int = 1
    options: OdeSolverOptions = field(default_factory=OdeSolverOptions)
    ic_options: InitialConditionOptions = field(default_factory=InitialConditionOptions)
    linear_solver: LinearSolverSpec = DENSE

    @property
    def dtype(self):
        return jnp.result_type(self.atol)

    def output_in_error_control(self) -> bool:
        return (
            self.integrate_out
            and self.eqn.out is not None
            and self.out_rtol is not None
            and self.out_atol is not None
        )

    def sens_in_error_control(self) -> bool:
        return self.sens_rtol is not None and self.sens_atol is not None


class OdeBuilder:
    """Fluent problem builder (reference builder.rs:112-1933).

    Example::

        problem = (
            OdeBuilder()
            .rhs(lambda t, y, p: -p[0] * y)
            .init(lambda t, p: jnp.array([1.0]))
            .p([0.1])
            .rtol(1e-6)
            .build()
        )

    Hand-written Jacobian closures (`rhs_implicit`) are optional: JAX AD
    supplies every derivative by default (the reference's `*_autodiff`
    builder methods are the norm here).
    """

    def __init__(self):
        self._rhs = None
        self._rhs_jac = None
        self._init = None
        self._mass = None
        self._root = None
        self._out = None
        self._reset = None
        self._reset_n = None  # index-aware reset (DiffSL N protocol)
        self._p = jnp.zeros((0,))
        self._t0 = 0.0
        self._h0 = 0.0  # 0 => use heuristic
        self._rtol = 1e-6
        self._atol = 1e-6
        self._out_rtol = None
        self._out_atol = None
        self._sens_rtol = None
        self._sens_atol = None
        self._param_rtol = None
        self._param_atol = None
        self._param_scales = None
        self._integrate_out = False
        self._options = OdeSolverOptions()
        self._ic_options = InitialConditionOptions()
        self._linear_solver = DENSE
        self._use_coloring = False
        self._dtype = None

    # equations ---------------------------------------------------------
    def rhs(self, f: Callable):
        self._rhs = f
        return self

    def rhs_implicit(self, f: Callable, jac: Callable):
        """RHS with an explicit Jacobian (t, y, p) -> matrix representation."""
        self._rhs = f
        self._rhs_jac = jac
        return self

    def init(self, f: Callable):
        self._init = f
        return self

    def mass(self, m: Callable):
        self._mass = m
        return self

    def root(self, g: Callable):
        self._root = g
        return self

    def out(self, g: Callable):
        self._out = g
        return self

    def reset(self, r: Callable):
        self._reset = r
        return self

    # settings ----------------------------------------------------------
    def p(self, params):
        self._p = jnp.asarray(params, dtype=jnp.result_type(float))
        return self

    def t0(self, t0: float):
        self._t0 = t0
        return self

    def h0(self, h0: float):
        self._h0 = h0
        return self

    def rtol(self, rtol: float):
        self._rtol = rtol
        return self

    def atol(self, atol):
        self._atol = atol
        return self

    def out_rtol(self, v):
        self._out_rtol = v
        return self

    def out_atol(self, v):
        self._out_atol = v
        return self

    def sens_rtol(self, v):
        self._sens_rtol = v
        return self

    def sens_atol(self, v):
        self._sens_atol = v
        return self

    def param_rtol(self, v):
        self._param_rtol = v
        return self

    def param_atol(self, v):
        self._param_atol = v
        return self

    def param_scales(self, v):
        """Absolute-tolerance scale per parameter for the adjoint
        parameter-gradient rows (reference builder.rs param_scales)."""
        self._param_scales = v
        return self

    def turn_off_sensitivities_error_control(self):
        """Exclude the sensitivity rows from the error test
        (reference builder.rs:1501)."""
        self._sens_rtol = None
        self._sens_atol = None
        return self

    def turn_off_output_error_control(self):
        """Exclude the quadrature output from the error test
        (reference builder.rs:1511)."""
        self._out_rtol = None
        self._out_atol = None
        return self

    def turn_off_param_error_control(self):
        """Exclude the adjoint parameter-gradient rows from the error
        test (reference builder.rs:1521)."""
        self._param_rtol = None
        self._param_atol = None
        return self

    def integrate_out(self, flag: bool = True):
        self._integrate_out = flag
        return self

    def options(self, opts: OdeSolverOptions):
        self._options = opts
        return self

    def ic_options(self, opts: InitialConditionOptions):
        self._ic_options = opts
        return self

    def linear_solver(self, spec):
        if spec == "krylov":
            # matrix-free GMRES needs the rhs closure: constructed in
            # build() (ops/krylov.make_krylov_solver)
            self._linear_solver = "krylov"
            return self
        self._linear_solver = get_solver(spec)
        return self

    def use_coloring(self, flag: bool = True):
        """Compress the Jacobian via sparsity detection + native greedy
        graph coloring (reference builder.rs use_coloring)."""
        self._use_coloring = flag
        return self

    def build_from_eqn(self, model) -> OdeProblem:
        """Build from an already-compiled :class:`~diffsol_tpu.diffsl.DiffslModel`
        (reference builder.rs `build_from_eqn`: reuse a compiled equations
        object across problems/settings)."""
        fns = model.make_callables(dtype=self._dtype)
        self._rhs = fns["rhs"]
        self._init = fns["init"]
        self._mass = fns.get("mass", self._mass)
        self._root = fns.get("root", self._root)
        self._out = fns.get("out", self._out)
        self._reset = fns.get("reset", self._reset)
        self._reset_n = fns.get("reset_n", self._reset_n)
        if self._p is None or self._p.size == 0:
            self._p = jnp.asarray(
                model.default_params, dtype=jnp.result_type(float)
            )
        elif self._p.shape[-1] != len(model.default_params):
            # JAX clamps out-of-bounds gathers, so a short params vector
            # would silently produce wrong dynamics; reject like the
            # reference's set_inputs length check
            raise ValueError(
                f"model declares {len(model.default_params)} inputs (in_i) "
                f"but .p(...) supplied {self._p.shape[-1]}"
            )
        # The reference's DiffSL bridge always extracts sparsity and holds a
        # JacobianColoring per operator (diffsl.rs:38-330).  Mirror that for
        # large models: at n >= 256 a dense Jacobian costs n JVPs per
        # evaluation, so the auto-router (blockdiag -> banded -> colored
        # dense) takes over unless the user chose a solver explicitly.
        if (
            not self._use_coloring
            and self._rhs_jac is None
            and self._linear_solver is DENSE
        ):
            try:
                p_probe = jnp.asarray(
                    self._p, dtype=jnp.result_type(float)
                )
                y0 = self._init(jnp.asarray(self._t0), p_probe)
                if int(y0.shape[-1]) >= 256:
                    self._use_coloring = True
            except Exception:
                pass
        problem = self.build()
        object.__setattr__(problem, "diffsl_model", model)
        return problem

    def build_from_diffsl(self, source: str) -> OdeProblem:
        """Build the problem from DiffSL model text (reference
        builder.rs `build_from_diffsl` -> diffsl.rs:239-330; here the DSL
        is traced into JAX callables instead of LLVM-compiled --
        see :mod:`diffsol_tpu.diffsl`).

        ``.p(...)`` overrides the ``in_i`` defaults; rhs/init/mass/root/
        out/reset come from the model's F/u/M/stop/out/reset tensors.
        """
        from .diffsl import compile_diffsl

        return self.build_from_eqn(compile_diffsl(source))

    def dtype(self, d):
        """Solve precision (reference ScalarType{F32,F64},
        diffsol-c/src/scalar_type.rs).  Default: the ambient float width
        (f64 under jax x64).  The init/rhs/mass/... callables are wrapped
        so their outputs (and all tolerance/params leaves) carry this dtype
        regardless of what the user closures return; under float32 the
        solver's matrix products run at full precision
        (:mod:`diffsol_tpu.precision`).
        """
        self._dtype = jnp.dtype(d)
        return self

    def _colored_jac_or_none(self, rhs_f, init_f):
        """Colored-probe dense-Jacobian extractor for the krylov lu32
        preconditioner, or None when detection fails or coloring does not
        pay (ncolors ~ n).  Host-side, build-time only."""
        import numpy as np

        from .ops.coloring import (
            detect_sparsity,
            greedy_color,
            make_colored_jac,
        )

        try:
            p_arr = jnp.asarray(self._p, dtype=jnp.result_type(float))
            t0_arr = jnp.asarray(self._t0)
            y0 = init_f(t0_arr, p_arr)
            n = int(y0.shape[-1])
            rows, cols = detect_sparsity(rhs_f, t0_arr, y0, p_arr, n)
            colors, ncolors = greedy_color(rows, cols, n, n)
            if ncolors >= max(n // 2, 8):
                return None
            return make_colored_jac(rhs_f, rows, cols, colors, ncolors, n)
        except Exception:
            return None

    # build --------------------------------------------------------------
    def build(self) -> OdeProblem:
        if self._rhs is None or self._init is None:
            raise ValueError("OdeBuilder requires at least .rhs(...) and .init(...)")
        # work on LOCALS: build() must not mutate the builder's stored
        # callables (a second build() would stack dtype wrappers / reuse a
        # stale auto-detected jacobian tier)
        rhs_f, init_f = self._rhs, self._init
        mass_f, root_f = self._mass, self._root
        out_f, reset_f = self._out, self._reset
        reset_n_f = self._reset_n
        rhs_jac_f = self._rhs_jac
        linear_solver = self._linear_solver
        if self._dtype is not None:
            cast = self._dtype

            def _c(f):
                if f is None:
                    return None
                return lambda *a: jnp.asarray(f(*a), cast)

            rhs_f = _c(rhs_f)
            init_f = _c(init_f)
            mass_f = _c(mass_f)
            root_f = _c(root_f)
            out_f = _c(out_f)
            reset_f = _c(reset_f)
            reset_n_f = _c(reset_n_f)
            rhs_jac_f = _c(rhs_jac_f)
        if linear_solver == "krylov":
            from .ops.krylov import make_krylov_jac, make_krylov_solver

            linear_solver = make_krylov_solver(
                rhs_f, jac_fn=self._colored_jac_or_none(rhs_f, init_f)
            )
            rhs_jac_f = make_krylov_jac()
        if linear_solver.name.startswith("banded") and rhs_jac_f is None:
            from .ops.banded import make_banded_jac

            ml, mu = linear_solver.meta[:2]
            rhs_jac_f = make_banded_jac(rhs_f, ml, mu)
        elif self._use_coloring and rhs_jac_f is None:
            import numpy as np

            from .ops.banded import make_banded_jac, make_banded_solver
            from .ops.coloring import (
                detect_sparsity,
                greedy_color,
                make_colored_jac,
            )

            p_arr = jnp.asarray(self._p, dtype=jnp.result_type(float))
            t0_arr = jnp.asarray(self._t0)
            y0 = init_f(t0_arr, p_arr)
            n = int(y0.shape[-1])
            rows, cols = detect_sparsity(rhs_f, t0_arr, y0, p_arr, n)
            ml = int(np.max(rows - cols)) if len(rows) else 0
            mu = int(np.max(cols - rows)) if len(rows) else 0
            if mass_f is not None:
                # the iteration matrix is M - c J: the band must cover M too
                m0 = np.asarray(mass_f(t0_arr, p_arr))
                mi, mj = np.nonzero(m0)
                if len(mi):
                    ml = max(ml, int(np.max(mi - mj)))
                    mu = max(mu, int(np.max(mj - mi)))
            # tier routing order (all playing the reference KLU role,
            # suitesparse/klu.rs:1-245):
            # 1. independent dense blocks (robertson_ode ngroups layouts,
            #    circuit components): exact structure, zero fill-in, pivoted
            #    batch-last LU -- safe for stiff blocks where the no-pivot
            #    band LU is not;
            # 2. narrow band (MOL stencils): banded probes + band LU;
            # 3. colored-probe dense fallback.
            blk_rows, blk_cols = rows, cols
            if mass_f is not None:
                m0 = np.asarray(mass_f(t0_arr, p_arr))
                mi, mj = np.nonzero(m0)
                blk_rows = np.concatenate([rows, mi])
                blk_cols = np.concatenate([cols, mj])
            blocks = None
            if n >= 8:
                from .ops.blockdiag import (
                    detect_blocks,
                    make_blockdiag_jac,
                    make_blockdiag_solver,
                )

                blocks = detect_blocks(blk_rows, blk_cols, n)
            if blocks is not None:
                perm, nb_, K_ = blocks
                rhs_jac_f = make_blockdiag_jac(rhs_f, perm, nb_, K_, n)
                linear_solver = make_blockdiag_solver(perm, nb_, K_, n)
            elif n >= 8 and ml + mu + 1 <= max(n // 2, 1):
                rhs_jac_f = make_banded_jac(rhs_f, ml, mu)
                linear_solver = make_banded_solver(ml, mu)
            else:
                colors, ncolors = greedy_color(rows, cols, n, n)
                rhs_jac_f = make_colored_jac(
                    rhs_f, rows, cols, colors, ncolors, n
                )
        mass_diag_f = None
        if mass_f is not None:
            # structurally diagonal mass -> elementwise fast path (the
            # common DAE case; probed concretely like the sparsity
            # detection, same structure-independence caveat)
            import numpy as np

            p_arr0 = jnp.asarray(self._p, dtype=jnp.result_type(float))
            # probe at several time points AND perturbed params: a time- or
            # parameter-dependent mass whose off-diagonals merely vanish at
            # (t0, p) must not be silently treated as diagonal
            t0f = float(np.asarray(self._t0))
            probes = [
                (t0f, p_arr0),
                (t0f + 1.0, p_arr0),
                (t0f + 0.5, p_arr0 * 1.25 + 0.125),
            ]
            def _diag_only(m):
                return m.ndim == 2 and np.count_nonzero(
                    m - np.diag(np.diag(m))
                ) == 0
            if all(
                _diag_only(np.asarray(mass_f(jnp.asarray(tp), pp)))
                for tp, pp in probes
            ):
                _mf = mass_f

                def mass_diag_f(t, p):
                    return jnp.diagonal(_mf(t, p))

        eqn = make_equations(
            rhs_f,
            init_f,
            self._p,
            self._t0,
            mass=mass_f,
            root=root_f,
            out=out_f,
            reset=reset_f,
            rhs_jac=rhs_jac_f,
            mass_diag=mass_diag_f,
            reset_n=reset_n_f,
        )
        dtype = self._dtype or jnp.result_type(float)
        atol = jnp.asarray(self._atol, dtype)
        if atol.ndim == 0:
            atol = jnp.full((eqn.nstates,), atol, dtype)

        def _vecify(v, nv):
            if v is None:
                return None
            v = jnp.asarray(v, dtype)
            if v.ndim == 0:
                v = jnp.full((nv,), v, dtype)
            return v

        return OdeProblem(
            eqn=eqn,
            params=jnp.asarray(self._p, dtype),
            t0=jnp.asarray(self._t0, dtype),
            h0=jnp.asarray(self._h0, dtype),
            rtol=jnp.asarray(self._rtol, dtype),
            atol=atol,
            out_rtol=None if self._out_rtol is None else jnp.asarray(self._out_rtol, dtype),
            out_atol=_vecify(self._out_atol, eqn.nout),
            sens_rtol=None if self._sens_rtol is None else jnp.asarray(self._sens_rtol, dtype),
            sens_atol=_vecify(self._sens_atol, eqn.nstates),
            param_rtol=None if self._param_rtol is None else jnp.asarray(self._param_rtol, dtype),
            param_atol=_vecify(self._param_atol, eqn.nparams),
            param_scales=_vecify(self._param_scales, eqn.nparams),
            integrate_out=self._integrate_out,
            options=self._options,
            ic_options=self._ic_options,
            linear_solver=linear_solver,
        )
