"""Per-op container micro-benches (role of reference
crates/diffsol/benches/lin_alg_ops.rs:1-40: axpy / norm / LU factor+solve
over sizes 2..500 per backend).

Prints one JSON line per (op, n, B) with the median per-call time and the
device it ran on.  Runs on the GPU (default env) or the CPU
(JAX_PLATFORMS=cpu).  Not part of bench.py -- this is the developer's
per-op tool.

Usage: python scripts/bench_linalg_ops.py [--quick]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)


def marginal(fn, *args, reps=8):
    """Median per-call seconds of a compiled ``fn``, each call timed
    around ``block_until_ready``."""
    jax.block_until_ready(fn(*args))  # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def emit(op, n, B, seconds):
    dev = jax.devices()[0]
    print(json.dumps({"op": op, "n": n, "B": B, "us": seconds * 1e6,
                      "device": f"{dev.platform}:{dev.device_kind}"}),
          flush=True)


def main():
    quick = "--quick" in sys.argv
    from diffsol_tpu.norms import squared_norm
    from diffsol_tpu.ops import smalllu
    from diffsol_tpu.ops.banded import make_banded_solver

    sizes = [2, 10, 100] if quick else [2, 10, 30, 100, 300, 500]
    batches = [1, 1000] if quick else [1, 100, 10_000]
    rng = np.random.default_rng(0)

    # vector ops (reference vector/mod.rs axpy + squared_norm)
    for n in sizes:
        for B in batches:
            x = jnp.asarray(rng.standard_normal((n, B)))
            y = jnp.asarray(rng.standard_normal((n, B)))
            axpy = jax.jit(lambda a, b: 2.5 * a + b)
            emit("axpy", n, B, marginal(axpy, x, y))
            nrm = jax.jit(
                lambda a, b: squared_norm(a, b, 1e-6, 1e-4, nbatch=b.shape[-1])
            )
            emit("wrms_norm", n, B, marginal(nrm, x, y))

    # batch-last dense LU (reference CudaLU per-batch loop, cuda/lu.rs)
    for n in [s for s in sizes if s <= 100]:
        for B in batches:
            a = jnp.asarray(rng.standard_normal((n, n, B)))
            a = a + jnp.eye(n)[:, :, None] * (2.0 * n)
            b = jnp.asarray(rng.standard_normal((n, B)))
            fac = jax.jit(smalllu.lu_factor_batch_last)
            emit("lu_factor_batch_last", n, B, marginal(fac, a))
            f = fac(a)

            sol = jax.jit(smalllu.lu_solve_batch_last)
            emit("lu_solve_batch_last", n, B, marginal(sol, f, b))

    # banded LU (the KLU-role tier for MOL stencils)
    for n in [s for s in sizes if s >= 30]:
        ml = mu = 3
        nb = ml + mu + 1
        for B in batches[:2]:
            band = jnp.asarray(rng.standard_normal((nb, n, B)))
            band = band.at[mu].add(4.0 * nb)
            rhs = jnp.asarray(rng.standard_normal((n, B)))
            spec = make_banded_solver(ml, mu)
            fac = jax.jit(spec.factor)
            emit("band_factor", n, B, marginal(fac, band))
            f = fac(band)
            sol = jax.jit(spec.solve)
            emit("band_solve", n, B, marginal(sol, f, rhs))


if __name__ == "__main__":
    main()
