"""Full-precision float32 matrix products inside the solver programs.

A GPU runs a float32 matrix product in TF32 (about three decimal digits)
unless the product asks for more.  Under ``OdeBuilder().dtype(jnp.float32)``
that would hold every stage combination, Newton update and user ``rhs``
product to a precision far below the solver's tolerances, so the solver's
programs are traced with ``jax.default_matmul_precision("highest")``.
float64 products are unaffected.
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Trace ``fn`` with float32 matrix products at ``Precision.HIGHEST``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
