"""Choices the code makes from what it can observe: linear-solver routing
(the same on every backend), ensemble modes, the banded kernel, the
compile-cache directory, the benchmark's peak table, and full-precision
float32 matrix products inside the solver programs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import diffsol_tpu as dt
from diffsol_tpu import compile_cache
from diffsol_tpu.models import exponential_decay
from diffsol_tpu.ops.banded import make_banded_solver


@pytest.mark.parametrize("backend", ["cpu", "gpu", "other"])
def test_linear_solver_routing_ignores_backend(monkeypatch, backend):
    """A large unstructured pattern takes the colored dense route whatever
    the backend reports; a narrow band takes the banded tier."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    n = 256
    c = jnp.asarray(np.random.default_rng(0).uniform(-0.01, 0.01, (n, n)))
    dense = (
        dt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y + c @ y)
        .init(lambda t, p: jnp.ones((n,))).p([1.0]).use_coloring().build()
    )
    assert dense.linear_solver.name.startswith("dense")

    def lap(t, y, p):
        z = jnp.zeros_like(y[:1])
        return jnp.concatenate([z, y[:-1]]) - 2.0 * y + jnp.concatenate(
            [y[1:], z])

    band = (
        dt.OdeBuilder().rhs(lap).init(lambda t, p: jnp.ones((32,)))
        .p([1.0]).use_coloring().build()
    )
    assert band.linear_solver.meta[:2] == (1, 1)


@pytest.mark.parametrize("mode", ["fused", "auto"])
def test_ensemble_rejects_removed_modes(mode):
    problem = exponential_decay.problem()
    with pytest.raises(ValueError, match="'lockstep', 'independent'"):
        dt.solve_dense_ensemble(dt.BdfSolver, problem, [1.0],
                                jnp.ones((4, 2)), mode=mode)


@pytest.mark.parametrize("backend,kernel", [("cpu", "xla"), ("gpu", "triton")])
def test_banded_auto_kernel(monkeypatch, backend, kernel):
    """``kernel="auto"`` takes the Triton kernel where it compiles (a GPU)
    and the XLA form elsewhere; interpret mode is never chosen for the
    caller."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    spec = make_banded_solver(2, 3)
    assert spec.meta == (2, 3, kernel)
    assert spec.name == f"banded(2,3,{kernel})"


def test_banded_rejects_unknown_kernel():
    with pytest.raises(ValueError, match="'triton', 'xla'"):
        make_banded_solver(1, 1, kernel="pallas")


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch):
    """Without the variable the cache is the checkout's fixed .jax_cache/:
    no temp name, pid or time in the path."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert compile_cache.configure_compile_cache() == path


def test_bench_peaks_for_h100():
    import bench

    peak = bench.peaks("NVIDIA H100 80GB HBM3")
    assert peak == {"float64_flops": 34.0e12, "float32_flops": 67.0e12,
                    "hbm_bytes_s": 3.35e12}


def test_bench_peaks_unknown_device_has_no_default():
    import bench

    assert bench.peaks("NVIDIA A100-SXM4-40GB") is None
    assert bench.peaks("unknown accelerator") is None


def _dot_precisions(jaxpr):
    """The precision of every dot_general in a closed jaxpr, sub-jaxprs
    (while/cond/pjit bodies) included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found.extend(_dot_precisions(sub))
    return found


@pytest.mark.parametrize("solver", ["bdf", "tsit45"])
def test_f32_solve_matmuls_at_highest_precision(solver):
    """Under .dtype(float32) every matrix product of the solve program --
    the user's rhs, the stage combinations, the Newton updates -- asks for
    Precision.HIGHEST, so a GPU does not drop it to TF32.  (The SDIRK
    solvers do not trace under float32 yet: a float64 leaks into their
    stage loop.)"""
    a = jnp.asarray([[-1.0, 0.5, 0.0], [0.2, -2.0, 0.3], [0.0, 0.4, -3.0]])
    problem = (
        dt.OdeBuilder()
        .rhs(lambda t, y, p: p[0] * (a @ y))
        .init(lambda t, p: jnp.ones((3,)))
        .p([1.0])
        .dtype(jnp.float32)
        .build()
    )
    s = dt.solver(problem, solver)
    jaxpr = jax.make_jaxpr(
        lambda p: dt.solve_dense(s, jnp.asarray([0.5, 1.0], jnp.float32),
                                 params=p).ys
    )(problem.params)
    precisions = _dot_precisions(jaxpr.jaxpr)
    assert precisions, "no matrix products traced"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), set(precisions)
