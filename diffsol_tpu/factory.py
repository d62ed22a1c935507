"""Runtime-dispatch solver factory.

The equivalent of the reference's runtime-polymorphism layer
(reference crates/diffsol-c/src/ode_solver_type.rs `OdeSolverType`
{Bdf, Esdirk34, TrBdf2, Tsit45} + ode_solver_tag.rs dispatch and the
per-solver factory methods on `OdeSolverProblem`, problem.rs:597-1204):
method selection by name, mapped onto the concrete stepper classes.
"""

from __future__ import annotations

from .problem import OdeProblem
from .solvers.bdf import BdfSolver
from .solvers.erk import ErkSolver
from .solvers.sdirk import SdirkSolver
from .solvers.tableau import esdirk34, tr_bdf2, tsit45

METHODS = ("bdf", "tr_bdf2", "esdirk34", "tsit45")


def solver(problem: OdeProblem, method: str = "bdf", **kwargs):
    """Create a solver by method name (reference OdeSolverType dispatch).

    ``bdf`` -> variable-order NDF/BDF; ``tr_bdf2``/``esdirk34`` -> SDIRK;
    ``tsit45`` -> explicit RK.  Extra kwargs pass to the solver class
    (e.g. ``sens=True`` for BDF, ``config=...``).
    """
    m = method.lower()
    if m == "bdf":
        return BdfSolver(problem, **kwargs)
    if m == "tr_bdf2":
        return SdirkSolver(problem, tableau=tr_bdf2(), **kwargs)
    if m == "esdirk34":
        return SdirkSolver(problem, tableau=esdirk34(), **kwargs)
    if m == "tsit45":
        return ErkSolver(problem, tableau=tsit45(), **kwargs)
    raise ValueError(f"unknown method {method!r}; available: {METHODS}")
