"""diffsol_tpu: an ODE/DAE solver framework in JAX/XLA/Pallas.

Built from scratch with the capabilities of the `diffsol` reference
(variable-order BDF/NDF, SDIRK TR-BDF2/ESDIRK34, explicit TSIT45, adaptive
step/order control, singular-mass DAEs with consistent ICs, events with
resets, quadrature, forward and adjoint sensitivities) re-designed for an
accelerator: solvers are jitted ``lax.while_loop`` state machines over pytrees, AD comes
from JAX, ensembles come from ``vmap`` + mesh sharding.
"""

from . import errors  # noqa: F401
from .drivers import Solution, solve, solve_dense  # noqa: F401
from .ensemble import make_lockstep_problem, solve_dense_ensemble  # noqa: F401
from .factory import METHODS, solver  # noqa: F401
from .adjoint import (  # noqa: F401
    make_differentiable_quadrature,
    make_differentiable_solve,
)
from .adjoint_ensemble import (  # noqa: F401
    make_differentiable_quadrature_ensemble,
    make_differentiable_solve_ensemble,
)
from .diffsl import DiffslModel, compile_diffsl  # noqa: F401
from .sens import solve_dense_fwd_sens  # noqa: F401
from .equations import OdeEquations, make_equations  # noqa: F401
from .problem import (  # noqa: F401
    InitialConditionOptions,
    OdeBuilder,
    OdeProblem,
    OdeSolverOptions,
    SolverConfig,
)
from .solvers import (  # noqa: F401
    BdfSolver,
    ErkSolver,
    SdirkSolver,
    Tableau,
    esdirk34,
    tr_bdf2,
    tsit45,
)

__version__ = "0.1.0"
