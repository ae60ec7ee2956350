"""Sorted cell-ordered transfer — the scale path (SURVEY.md §7.2 step 5).

The dense backend scatters every tap in particle order.  This backend sorts
ONCE per substep — particles are ordered by flattened cell id — and then every
P2G scatter becomes ``jax.ops.segment_sum`` with ``indices_are_sorted=True``:
for a fixed stencil offset, target cell id = sorted base id + constant, which
stays monotonic, so each of the 3^D per-offset segment-sums sees sorted ids.

This is the array replacement for BOTH of the reference's spatial
structures: the hash-map chunking (``particles_mul``, ``2d_multi.rs:52``) and
the ``swap_mul`` migration buffers (``2d_multi.rs:327-358``) — "migration" is
simply next substep's re-sort (SURVEY.md §5.7).

Particles are returned in their original slot order (one inverse-permutation
gather), so this backend is a drop-in for the dense one; results differ only
in f32 summation order (quirk Q5, covered by the 1e-3 tolerance and the
equivalence tests in tests/test_backends.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..domain import Domain
from ..state import GridState, ParticleState
from . import transfer
from .bspline import _stencil_offsets_np, quadratic_weights, stencil_weights
from .eos import stress_tensor, tait_pressure


def _flat_strides(shape: Tuple[int, ...]) -> np.ndarray:
    """C-order strides (in elements) for flattening cell coordinates."""
    return np.array(
        [int(np.prod(shape[d + 1 :], dtype=np.int64)) for d in range(len(shape))],
        np.int32,
    )


def sort_by_cell(p: ParticleState, domain: Domain):
    """Order particles by flattened cell id.

    Returns (sorted state, sorted flat cell id [N], inverse permutation [N]).
    """
    strides = jnp.asarray(_flat_strides(domain.shape))
    origin = jnp.asarray(domain.origin, jnp.int32)
    cell = jnp.floor(p.pos).astype(jnp.int32) - origin  # [N, D]
    # Out-of-grid cells (cannot happen for clamped reference configs, but keep
    # the same drop semantics): clamp per axis — taps are masked later anyway.
    cell = jnp.clip(cell, 0, jnp.asarray(domain.shape, jnp.int32) - 1)
    flat = (cell * strides).sum(axis=-1)  # [N]
    order = jnp.argsort(flat)
    inv = jnp.argsort(order)
    sorted_p = jax.tree.map(lambda a: jnp.take(a, order, axis=0), p)
    return sorted_p, jnp.take(flat, order), inv


def _tap_ids_and_masks(p: ParticleState, flat_sorted: jnp.ndarray, domain: Domain):
    """Per-tap geometry for cell-sorted particles.

    Returns (ids [K][N] clamped+monotonic, valid [N, K], w [N, K], dpos [N, K, D]).
    """
    dim = p.dim
    offs_np = _stencil_offsets_np(dim) - 1  # [K, D] in {-1,0,1}
    strides_np = _flat_strides(domain.shape)
    shape = jnp.asarray(domain.shape, jnp.int32)
    origin = jnp.asarray(domain.origin, jnp.int32)

    cell = jnp.floor(p.pos).astype(jnp.int32)  # [N, D] world cells
    diff = p.pos - (cell.astype(p.pos.dtype) + 0.5)
    w = stencil_weights(quadratic_weights(diff))  # [N, K]

    idx0 = cell - origin  # [N, D]
    offs = jnp.asarray(offs_np)
    idxk = idx0[:, None, :] + offs[None]  # [N, K, D]
    valid = jnp.all((idxk >= 0) & (idxk < shape), axis=-1)  # [N, K]
    dpos = (
        (cell[:, None, :] + offs[None]).astype(p.pos.dtype) + 0.5
    ) - p.pos[:, None, :]  # [N, K, D]

    ncells = domain.num_cells
    ids = []
    for k, off in enumerate(offs_np):
        shift = int((off * strides_np).sum())
        ids.append(jnp.clip(flat_sorted + shift, 0, ncells - 1))  # monotonic
    return ids, valid, w, dpos


def _seg_sum(vals: jnp.ndarray, ids: jnp.ndarray, ncells: int) -> jnp.ndarray:
    return jax.ops.segment_sum(vals, ids, num_segments=ncells, indices_are_sorted=True)


def substep(
    p: ParticleState,
    cfg: Config,
    domain: Domain,
    mouse_pos: jnp.ndarray,
    mouse_active: jnp.ndarray,
) -> Tuple[ParticleState, GridState]:
    """One fused substep on the cell-sorted layout.

    Phases are the same four as the reference (p2g_1 ``2d_multi.rs:148-180``,
    p2g_2 ``:182-238``, update ``:240-250``, g2p ``:252-359``); only the
    scatter machinery differs from ops.transfer.
    """
    ncells = domain.num_cells
    dim = p.dim

    ps, flat, inv = sort_by_cell(p, domain)
    ids, valid, w, dpos = _tap_ids_and_masks(ps, flat, domain)
    K = len(ids)

    # ---- p2g_1: mass + APIC momentum ------------------------------------
    mc = jnp.where(valid, w * ps.mass[:, None], 0.0)  # [N, K]
    q = jnp.einsum("nij,nkj->nki", ps.C, dpos, precision=jax.lax.Precision.HIGHEST)  # [N, K, D]
    mom = mc[..., None] * (ps.vel[:, None, :] + q)  # [N, K, D]

    grid_m = jnp.zeros((ncells,), p.pos.dtype)
    grid_mv = jnp.zeros((ncells, dim), p.pos.dtype)
    for k in range(K):
        grid_m = grid_m + _seg_sum(mc[:, k], ids[k], ncells)
        grid_mv = grid_mv + _seg_sum(mom[:, k, :], ids[k], ncells)

    # ---- p2g_2: density gather + EOS + force scatter --------------------
    wv = jnp.where(valid, w, 0.0)
    density = jnp.zeros((ps.n,), p.pos.dtype)
    for k in range(K):
        density = density + wv[:, k] * jnp.take(grid_m, ids[k], axis=0)

    pos_density = jnp.where(density > 0.0, density, 1.0)
    volume = jnp.where(density > 0.0, ps.mass / pos_density, 0.0)
    pressure = tait_pressure(
        density, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power, cfg.pressure_floor
    )
    stress = stress_tensor(ps.C, pressure, cfg.dynamic_viscosity)
    term = (-4.0 * cfg.dt) * volume[:, None, None] * stress  # [N, D, D]
    contrib = wv[..., None] * jnp.einsum("nij,nkj->nki", term, dpos, precision=jax.lax.Precision.HIGHEST)  # [N, K, D]
    for k in range(K):
        grid_mv = grid_mv + _seg_sum(contrib[:, k, :], ids[k], ncells)

    # ---- update_grid ----------------------------------------------------
    g = jnp.asarray(cfg.gravity, p.pos.dtype)
    m = grid_m[:, None]
    grid_v = jnp.where(m > 0.0, grid_mv / jnp.where(m > 0.0, m, 1.0) + cfg.dt * g, 0.0)

    # ---- g2p: gather + advect + BCs -------------------------------------
    vel = jnp.zeros_like(ps.vel)
    B = jnp.zeros_like(ps.C)
    for k in range(K):
        wvk = wv[:, k, None] * jnp.take(grid_v, ids[k], axis=0)  # [N, D]
        vel = vel + wvk
        B = B + wvk[:, :, None] * dpos[:, k, None, :]  # outer(wv, dpos)
    C = 4.0 * B
    pos = ps.pos + vel * cfg.dt

    # mouse (quirk Q3) + clamp + soft wall (quirk Q2) — same as dense path
    plane = pos[..., :2]
    dist = plane - mouse_pos
    dist_sq = jnp.sum(dist * dist, axis=-1)
    norm = jnp.sqrt(dist_sq)
    push2 = jnp.where(
        norm[..., None] > 0.0, dist / jnp.where(norm > 0.0, norm, 1.0)[..., None], 0.0
    )
    hit = mouse_active & (dist_sq < cfg.mouse_radius * cfg.mouse_radius)
    push = jnp.zeros_like(vel).at[..., :2].set(push2)
    vel = vel + jnp.where(hit[..., None], push, 0.0)

    lo = jnp.asarray(cfg.boundary_clip[0], pos.dtype)
    hi = jnp.asarray(cfg.boundary_clip[1], pos.dtype)
    pos = jnp.clip(pos, lo, hi)
    nxt = pos + vel
    wall_min = lo + cfg.boundary_damp_dist
    wall_max = hi - cfg.boundary_damp_dist
    vel = vel + jnp.where(nxt < wall_min, wall_min - nxt, 0.0)
    vel = vel + jnp.where(nxt > wall_max, wall_max - nxt, 0.0)

    out_sorted = ParticleState(
        pos=pos, vel=vel, C=C, mass=ps.mass, density=density, pressure=pressure
    )
    # Back to original slot order (drop-in equivalence with the dense backend).
    out = jax.tree.map(lambda a: jnp.take(a, inv, axis=0), out_sorted)
    grid = GridState(
        mass=grid_m.reshape(domain.shape),
        vel=grid_v.reshape(*domain.shape, dim),
    )
    return out, grid
