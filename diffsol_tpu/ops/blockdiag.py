"""Block-diagonal sparse tier: coloring -> dense-block compression.

Role of the reference's general unstructured sparse LU (reference
crates/diffsol-la/src/linear_solver/suitesparse/klu.rs:1-245,
faer/sparse_lu.rs:91) for the pattern class that actually appears in its
benchmarks: robertson_ode's ngroups layout is a 3x3-block-diagonal Jacobian
(test_models/robertson_ode.rs duplicated groups), circuit netlists decompose
into small independent components, etc.

Design: a block-diagonal system IS an internal lockstep ensemble.  The
sparsity pattern's connected components become dense blocks laid out
batch-LAST (nb, nb, K) -- tiny block dims on the leading axes, the
block count K last and contiguous -- factored by the same no-gather
masked-select LU as lockstep ensembles (ops/smalllu.lu_factor_batch_last).
The Jacobian is built with nb cyclic JVP probes (coloring by
position-within-block: columns of different blocks never share a row), so
an n = 3000 robertson_ode Jacobian costs 3 rhs-JVPs and O(nb^2 K) memory
instead of n jacfwd columns and a dense (3000)^2 factorization.

Components smaller than the largest are padded with identity rows/cols
(their solve returns the RHS unchanged); a permutation gathers states into
(nb, K) block layout only at the two linear-solve boundaries -- residual
evaluation stays in the natural state order.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import smalllu
from .linsol import LinearSolverSpec

MAX_BLOCK = 16  # beyond this, block compression loses to banded/dense tiers


def detect_blocks(rows, cols, n):
    """Connected components of the sparsity graph (union-find).

    Returns (perm, nb, K) where ``perm`` is an (K*nb,) int array mapping
    padded block-layout positions to state indices (-1 = padding), ``nb``
    the (padded) block size and ``K`` the component count -- or None when
    the pattern does not decompose (single component, or a block exceeds
    MAX_BLOCK).
    """
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for r, c in zip(np.asarray(rows), np.asarray(cols)):
        ra, ca = find(int(r)), find(int(c))
        if ra != ca:
            parent[ra] = ca
    comp = {}
    for i in range(n):
        comp.setdefault(find(i), []).append(i)
    comps = list(comp.values())
    if len(comps) < 2:
        return None
    nb = max(len(c) for c in comps)
    if nb > MAX_BLOCK:
        return None
    K = len(comps)
    perm = np.full((K * nb,), -1, dtype=np.int64)
    for k, members in enumerate(comps):
        perm[k * nb : k * nb + len(members)] = sorted(members)
    return perm, nb, K


def make_blockdiag_jac(rhs, perm, nb: int, K: int, n: int):
    """Jacobian df/dy as batch-last dense blocks (nb, nb, K) via nb
    position-within-block JVP probes (the coloring: columns of different
    blocks never share a row, so one probe covers every block's column c)."""
    perm_np = np.asarray(perm)
    valid = perm_np >= 0
    perm_c = np.where(valid, perm_np, 0)
    # seed[c] has 1 at every state that is column c of its block
    seeds_np = np.zeros((nb, n))
    for c in range(nb):
        idx = perm_np[c::nb]
        idx = idx[idx >= 0]
        seeds_np[c, idx] = 1.0
    gather_rows = jnp.asarray(perm_c.reshape(K, nb).T)  # (nb, K)
    vmask = jnp.asarray(valid.reshape(K, nb).T)  # (nb, K)

    def jac(t, y, p):
        seeds = jnp.asarray(seeds_np, y.dtype)

        def probe(v):
            return jax.jvp(lambda yy: rhs(t, yy, p), (y,), (v,))[1]

        probes = jax.vmap(probe)(seeds)  # (nb, n): J @ seed_c
        # block[i, c, k] = (J e_c)[state of row i of block k]
        block = probes[:, gather_rows]  # (c=nb, i=nb, K)
        block = jnp.where(vmask[None, :, :], block, 0.0)
        return jnp.swapaxes(block, 0, 1)  # (i, c, K)

    jac.jvp_probes = nb  # OpStatistics jac_mul_evals accounting
    return jac


def make_blockdiag_solver(perm, nb: int, K: int, n: int) -> LinearSolverSpec:
    """LinearSolverSpec solving (M - c*J) x = b as K independent dense
    blocks with the batch-last no-gather lockstep LU."""
    perm_np = np.asarray(perm)
    valid = perm_np >= 0
    perm_c = np.where(valid, perm_np, 0)
    gather_idx = jnp.asarray(perm_c.reshape(K, nb).T)  # (nb, K)
    vmask = jnp.asarray(valid.reshape(K, nb).T)  # (nb, K)
    scatter_idx = jnp.asarray(perm_c[valid])
    take_pos = jnp.asarray(np.flatnonzero(valid))

    def assemble(mass, jac, c):
        from .linsol import DiagMass

        # jac is (nb, nb, K) from make_blockdiag_jac
        a = -c * jac
        if mass is None:
            eye = jnp.eye(nb, dtype=jac.dtype)[:, :, None]
            a = a + eye
        elif isinstance(mass, DiagMass):
            db = mass.d[gather_idx] * vmask  # (nb, K)
            a = a + jnp.eye(nb, dtype=jac.dtype)[:, :, None] * db[:, None, :]
        else:
            # mass (n, n): gather block entries M[perm_i, perm_j]
            ii = gather_idx[:, None, :]  # (nb, 1, K)
            jj = gather_idx[None, :, :]  # (1, nb, K)
            mb = mass[ii, jj]  # (nb, nb, K)
            pad = (~(vmask[:, None, :] & vmask[None, :, :]))
            eye = jnp.broadcast_to(
                jnp.eye(nb, dtype=jac.dtype)[:, :, None], mb.shape
            )
            mb = jnp.where(pad, 0.0, mb)
            a = jnp.where(pad, 0.0, a) + mb
        # identity on padding diagonal so the LU stays nonsingular
        diag_pad = (~vmask)[:, None, :] * jnp.eye(nb, dtype=jac.dtype)[:, :, None]
        return a + diag_pad

    def factor(a):
        return smalllu.lu_factor_batch_last(a)

    def solve(factors, b):
        if b.ndim == 2:  # augmented rows (naug, n)
            return jax.vmap(lambda v: solve(factors, v))(b)
        bb = b[gather_idx] * vmask  # (nb, K)
        x = smalllu.lu_solve_batch_last(factors, bb)
        flat = jnp.swapaxes(x, 0, 1).reshape(-1)[take_pos]
        return jnp.zeros_like(b).at[scatter_idx].set(flat)

    def placeholder(_n, dtype):
        eye = jnp.broadcast_to(jnp.eye(nb, dtype=dtype)[:, :, None], (nb, nb, K))
        return smalllu.lu_factor_batch_last(eye)

    return LinearSolverSpec(
        name=f"blockdiag({nb},{K})",
        assemble=assemble,
        factor=factor,
        solve=solve,
        placeholder_factors=placeholder,
        meta=(nb, K, np.asarray(perm)),
    )


def make_blockdiag_jac_lockstep(jac1, nb: int, K: int):
    """Lift a single-member blockdiag Jacobian (nb, nb, K) to the lockstep
    fused-batch layout (nb, nb, K*B): the block axis and the member axis
    are ONE batch-last axis, so a B-member ensemble of K-block problems
    factors as K*B independent tiny LUs along the last axis (the
    role of the reference per-batch CUDA LU over the nbatch context, cuda/lu.rs:69-96, with the robertson_ode duplicated-
    groups layout)."""

    def jac(t, Y, pb):
        j = jax.vmap(jac1, in_axes=(None, 1, 0), out_axes=3)(t, Y, pb)
        return j.reshape(j.shape[0], j.shape[1], -1)  # (nb, nb, K*B)

    if hasattr(jac1, "jvp_probes"):
        jac.jvp_probes = jac1.jvp_probes
    return jac


def make_blockdiag_solver_lockstep(perm, nb: int, K: int, n: int,
                                   B: int) -> LinearSolverSpec:
    """Batch-last blockdiag LU over the FUSED (K*B,) block-member axis.

    Operands: Jacobian (nb, nb, K*B) from :func:`make_blockdiag_jac_lockstep`,
    RHS (n, B) lockstep state, mass either None, DiagMass with (n, B)
    diagonal, or a dense (n, n, B) stack."""
    perm_np = np.asarray(perm)
    valid = perm_np >= 0
    perm_c = np.where(valid, perm_np, 0)
    gather_idx = jnp.asarray(perm_c.reshape(K, nb).T)  # (nb, K)
    vmask = jnp.asarray(valid.reshape(K, nb).T)  # (nb, K)
    scatter_idx = jnp.asarray(perm_c[valid])
    take_pos = jnp.asarray(np.flatnonzero(valid))

    def assemble(mass, jac, c):
        from .linsol import DiagMass

        a = -c * jac  # (nb, nb, K*B)
        if mass is None:
            a = a + jnp.eye(nb, dtype=jac.dtype)[:, :, None]
        elif isinstance(mass, DiagMass):
            # d (n, B) -> block diag (nb, K, B) -> fused (nb, K*B)
            db = mass.d[gather_idx] * vmask[:, :, None]
            db = db.reshape(nb, K * B)
            a = a + jnp.eye(nb, dtype=jac.dtype)[:, :, None] * db[:, None, :]
        else:
            # mass (n, n, B): gather block entries per member
            ii = gather_idx[:, None, :]  # (nb, 1, K)
            jj = gather_idx[None, :, :]  # (1, nb, K)
            mb = mass[ii, jj]  # (nb, nb, K, B)
            pad = ~(vmask[:, None, :] & vmask[None, :, :])  # (nb, nb, K)
            pad_f = jnp.broadcast_to(
                pad[:, :, :, None], (nb, nb, K, B)
            ).reshape(nb, nb, K * B)
            mb = jnp.where(pad[..., None], 0.0, mb).reshape(nb, nb, K * B)
            a = jnp.where(pad_f, 0.0, a) + mb
        diag_pad = (
            (~vmask)[:, None, :, None] * jnp.eye(nb, dtype=jac.dtype)[:, :, None, None]
        )
        return a + jnp.broadcast_to(diag_pad, (nb, nb, K, B)).reshape(
            nb, nb, K * B
        )

    def factor(a):
        return smalllu.lu_factor_batch_last(a)

    def solve(factors, b):
        if b.ndim == 3:  # augmented rows (naug, n, B)
            return jax.vmap(lambda v: solve(factors, v))(b)
        bb = b[gather_idx] * vmask[:, :, None]  # (nb, K, B)
        x = smalllu.lu_solve_batch_last(factors, bb.reshape(nb, K * B))
        x = x.reshape(nb, K, B)
        flat = jnp.swapaxes(x, 0, 1).reshape(K * nb, B)[take_pos]  # (nv, B)
        return jnp.zeros_like(b).at[scatter_idx].set(flat)

    def placeholder(_n, dtype):
        eye = jnp.broadcast_to(
            jnp.eye(nb, dtype=dtype)[:, :, None], (nb, nb, K * B)
        )
        return smalllu.lu_factor_batch_last(eye)

    return LinearSolverSpec(
        name=f"blockdiag_lockstep({nb},{K},{B})",
        assemble=assemble,
        factor=factor,
        solve=solve,
        placeholder_factors=placeholder,
        meta=(nb, K, np.asarray(perm), B),
    )
