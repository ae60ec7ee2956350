"""Particle<->grid transfer — dense, fully-vectorized reference path.

This module is the vectorized re-design of the reference's four pipeline
phases (``2d_multi.rs:148-359`` / ``3d_multi.rs:148-381``):

  p2g_1        scatter mass + APIC momentum        (2d_multi.rs:148-180)
  p2g_2        gather density, EOS, scatter force  (2d_multi.rs:182-238)
  grid_update  normalize momentum + gravity        (2d_multi.rs:240-250)
  g2p          gather velocity/C, advect, BCs      (2d_multi.rs:252-359)

Design notes (array-first, not a translation):

* The reference's serial per-particle loops over hash-map chunks become
  whole-array ops over [N] SoA arrays; the 3^D stencil loop becomes a
  broadcast against a static [3^D, D] offset table.  XLA fuses the weight
  computation into the scatters/gathers — nothing here materializes more than
  [N, 3^D(, D)] intermediates.
* Scatter-add uses ``array.at[idx...].add``; on a GPU XLA lowers it to
  atomic adds, so the summation order (and the last bits of a sum) can
  change from run to run.  The sorted+segment-sum path
  (``sorted_transfer.py``) and the per-tile contraction path
  (``tiled_transfer.py``) are interchangeable and equivalence-tested
  (SURVEY.md §4.4).
* Bounds handling: the reference skips a stencil tap when any coordinate
  falls outside the padded grid (``2d_multi.rs:165-167`` etc.).  Here taps
  carry an explicit validity mask; invalid taps contribute zero and index a
  clamped cell.  For all reference configs the padded halo makes every tap
  valid, so results agree exactly.
* ``clear_grid`` + the ``sparse_grid`` touched-cell list (``2d_multi.rs:
  136-146``) have no equivalent: grids are freshly-zeroed functional values
  each substep, which XLA fuses into the scatter's init (SURVEY.md quirk Q1).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import Config
from ..domain import Domain
from ..state import GridState, ParticleState
from .bspline import quadratic_weights, stencil_offsets, stencil_weights
from .eos import stress_tensor, tait_pressure


# ---------------------------------------------------------------------------
# Stencil geometry shared by all four phases
# ---------------------------------------------------------------------------


def stencil_geometry_raw(pos: jnp.ndarray, origin: jnp.ndarray, shape):
    """``stencil_geometry`` against an explicit grid window.

    ``origin`` may be a traced array — the sharded path passes each device's
    slab origin computed from ``lax.axis_index`` (SURVEY.md §5.7).  ``shape``
    stays static (it fixes array sizes).
    """
    dim = pos.shape[-1]
    cell = jnp.floor(pos).astype(jnp.int32)  # [N, D]
    diff = pos - (cell.astype(pos.dtype) + 0.5)  # [N, D] in [-0.5, 0.5)
    ws = quadratic_weights(diff)  # [N, 3, D]
    w = stencil_weights(ws)  # [N, K]

    offs = stencil_offsets(dim)  # [K, D]
    cell_n = cell[:, None, :] + (offs - 1)[None, :, :]  # [N, K, D]
    dpos = (cell_n.astype(pos.dtype) + 0.5) - pos[:, None, :]  # [N, K, D]

    shape_arr = jnp.asarray(shape, jnp.int32)
    idx = cell_n - origin  # [N, K, D]
    valid = jnp.all((idx >= 0) & (idx < shape_arr), axis=-1)  # [N, K]
    idx = jnp.clip(idx, 0, shape_arr - 1)
    return idx, dpos, w, valid


def stencil_geometry(pos: jnp.ndarray, domain: Domain):
    """Compute everything the 3^D stencil needs, vectorized over particles.

    Mirrors the per-particle prelude at ``2d_multi.rs:153-160``:
    ``cell_pos = floor(pos)``, ``cell_diff = pos - (cell_pos + 0.5)``,
    per-axis weights, then per-tap neighbor cell, combined weight, and the
    cell-center offset ``dpos = (cell_n + 0.5) - pos`` (the negation of the
    reference's ``cell_diff_n``, ``2d_multi.rs:159``).

    Returns:
      idx:   [N, K, D] int32 grid indices (cell_n - origin), clamped in-range
      dpos:  [N, K, D] f32 cell-center minus particle position
      w:     [N, K]    f32 combined stencil weights
      valid: [N, K]    bool tap-in-bounds mask (2d_multi.rs:165-167)
    """
    return stencil_geometry_raw(
        pos, jnp.asarray(domain.origin, jnp.int32), domain.shape
    )


def _split_idx(idx: jnp.ndarray) -> Tuple[jnp.ndarray, ...]:
    """[N, K, D] index array -> D flat [N*K] coordinate arrays for .at[]."""
    dim = idx.shape[-1]
    flat = idx.reshape(-1, dim)
    return tuple(flat[:, d] for d in range(dim))


def _scatter_add(grid: jnp.ndarray, idx, vals: jnp.ndarray) -> jnp.ndarray:
    """grid.at[idx].add(vals) with [N, K(, D)] vals flattened over taps."""
    coords = _split_idx(idx)
    vals = vals.reshape((len(coords[0]),) + vals.shape[idx.ndim - 1 :])
    return grid.at[coords].add(vals, mode="promise_in_bounds")


def _gather(grid: jnp.ndarray, idx) -> jnp.ndarray:
    """grid[idx] -> [N, K(, trailing)] values."""
    n, k, _ = idx.shape
    coords = _split_idx(idx)
    out = grid[coords]
    return out.reshape((n, k) + grid.shape[idx.shape[-1] :])


# ---------------------------------------------------------------------------
# Phase 1: scatter mass + APIC momentum (p2g_1, 2d_multi.rs:148-180)
# ---------------------------------------------------------------------------


def p2g_1(p: ParticleState, cfg: Config, domain: Domain) -> GridState:
    """Scatter ``w*m`` into cell mass and ``w*m*(v + C @ dpos)`` into cell
    momentum (stored in ``GridState.vel`` until ``grid_update`` normalizes it,
    exactly like the reference's ``Cell.vel`` dual use).

    The APIC term ``q = C @ dpos`` matches ``2d_multi.rs:162``
    (``p.affine_momentum * -cell_diff_n`` with ``dpos = -cell_diff_n``).
    """
    idx, dpos, w, valid = stencil_geometry(p.pos, domain)
    mass_contrib = jnp.where(valid, w * p.mass[:, None], 0.0)  # [N, K]
    q = jnp.einsum("nij,nkj->nki", p.C, dpos, precision=jax.lax.Precision.HIGHEST)  # [N, K, D]
    mom = mass_contrib[..., None] * (p.vel[:, None, :] + q)  # [N, K, D]

    grid_m = _scatter_add(jnp.zeros(domain.shape, p.pos.dtype), idx, mass_contrib)
    grid_mv = _scatter_add(jnp.zeros((*domain.shape, p.dim), p.pos.dtype), idx, mom)
    return GridState(mass=grid_m, vel=grid_mv)


# ---------------------------------------------------------------------------
# Phase 2: density gather + EOS + force scatter (p2g_2, 2d_multi.rs:182-238)
# ---------------------------------------------------------------------------


def p2g_2(
    p: ParticleState, grid: GridState, cfg: Config, domain: Domain
) -> Tuple[GridState, jnp.ndarray, jnp.ndarray]:
    """Gather per-particle density from cell mass, compute Tait pressure and
    viscous stress, and scatter the fused MLS-MPM force/momentum term.

    Returns (grid with updated momentum, density [N], pressure [N]).

    The fused term matches ``eg_16_term_0 = -4 * volume * stress * dt``
    (``2d_multi.rs:219``) applied per tap as ``w * term @ dpos``
    (``2d_multi.rs:233``, with ``dpos = -cell_diff_n``).
    """
    idx, dpos, w, valid = stencil_geometry(p.pos, domain)
    w = jnp.where(valid, w, 0.0)

    cell_mass = _gather(grid.mass, idx)  # [N, K]
    density = jnp.sum(cell_mass * w, axis=-1)  # [N]

    # density > 0 wherever a real particle exists (self-tap weight >= 0.25^D);
    # the guard keeps zero-mass padding/ghost particles from injecting NaNs.
    pos_density = jnp.where(density > 0.0, density, 1.0)
    volume = jnp.where(density > 0.0, p.mass / pos_density, 0.0)  # [N]
    pressure = tait_pressure(
        density, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power, cfg.pressure_floor
    )
    stress = stress_tensor(p.C, pressure, cfg.dynamic_viscosity)  # [N, D, D]
    term = (-4.0 * cfg.dt) * volume[:, None, None] * stress  # [N, D, D]

    # Per-tap momentum contribution: w * term @ dpos  -> [N, K, D]
    contrib = w[..., None] * jnp.einsum("nij,nkj->nki", term, dpos, precision=jax.lax.Precision.HIGHEST)
    grid_mv = _scatter_add(grid.vel, idx, contrib)
    return GridState(mass=grid.mass, vel=grid_mv), density, pressure


# ---------------------------------------------------------------------------
# Phase 3: grid momentum -> velocity + gravity (update_grid, 2d_multi.rs:240-250)
# ---------------------------------------------------------------------------


def grid_update(grid: GridState, cfg: Config) -> GridState:
    """``vel = where(mass > 0, momentum / mass + dt * gravity, 0)``.

    The reference's ``is_computed`` dedup flag (``2d_multi.rs:244-248``) is
    unnecessary: every cell is updated exactly once (SURVEY.md quirk Q1).
    """
    g = jnp.asarray(cfg.gravity, grid.vel.dtype)
    m = grid.mass[..., None]
    vel = jnp.where(m > 0.0, grid.vel / jnp.where(m > 0.0, m, 1.0) + cfg.dt * g, 0.0)
    return GridState(mass=grid.mass, vel=vel)


# ---------------------------------------------------------------------------
# Phase 4: gather, advect, boundaries (g2p, 2d_multi.rs:252-359)
# ---------------------------------------------------------------------------


def g2p(
    p: ParticleState,
    grid: GridState,
    cfg: Config,
    domain: Domain,
    mouse_pos: jnp.ndarray,
    mouse_active: jnp.ndarray,
    density: jnp.ndarray,
    pressure: jnp.ndarray,
) -> ParticleState:
    """Gather grid velocity, rebuild the APIC C matrix, advect, and apply
    mouse + boundary conditions.

    Parity-critical details (SURVEY.md §2.3):
      * B_ij = sum_k w_k * v_i * dpos_j (outer product; matches the reference's
        ``Mat2::from_cols(wv * -cd.x, wv * -cd.y)`` which is column-major,
        ``2d_multi.rs:279-282``), and C = 4 B (``2d_multi.rs:288``).
      * Mouse repulsion applies AFTER ``pos += vel*dt`` (quirk Q3,
        ``2d_multi.rs:289-298``); in 3D it acts on the xy plane only
        (``3d_multi.rs:305-310``).
      * Soft wall uses the UN-scaled lookahead ``pos + vel`` (no dt) computed
        from the already-clamped position (quirk Q2, ``2d_multi.rs:302-325``).

    The reference's chunk-migration machinery (``swap_mul`` staging +
    append, ``2d_multi.rs:327-358``) has no equivalent: particles live in one
    fixed array; any spatial ordering is (re)established by the sorted
    transfer path, not by data movement here.
    """
    idx, dpos, w, valid = stencil_geometry(p.pos, domain)
    w = jnp.where(valid, w, 0.0)

    v_cell = _gather(grid.vel, idx)  # [N, K, D]
    wv = w[..., None] * v_cell  # [N, K, D]
    vel = jnp.sum(wv, axis=1)  # [N, D]
    # B_ij = sum_k wv_i * dpos_j
    B = jnp.einsum("nki,nkj->nij", wv, dpos, precision=jax.lax.Precision.HIGHEST)  # [N, D, D]
    C = 4.0 * B

    pos = p.pos + vel * cfg.dt

    # Mouse repulsion (always traced; masked by mouse_active — keeps the
    # frame program static so interactive frames never retrace).
    plane = pos[..., :2]
    dist = plane - mouse_pos
    dist_sq = jnp.sum(dist * dist, axis=-1)
    norm = jnp.sqrt(dist_sq)
    push2 = jnp.where(norm[..., None] > 0.0, dist / jnp.where(norm > 0.0, norm, 1.0)[..., None], 0.0)
    hit = mouse_active & (dist_sq < cfg.mouse_radius * cfg.mouse_radius)
    push = jnp.zeros_like(vel).at[..., :2].set(push2)
    vel = vel + jnp.where(hit[..., None], push, 0.0)

    # Hard clamp (2d_multi.rs:302-306)
    lo = jnp.asarray(cfg.boundary_clip[0], pos.dtype)
    hi = jnp.asarray(cfg.boundary_clip[1], pos.dtype)
    pos = jnp.clip(pos, lo, hi)

    # Soft wall with un-scaled lookahead (2d_multi.rs:308-325)
    nxt = pos + vel
    wall_min = lo + cfg.boundary_damp_dist
    wall_max = hi - cfg.boundary_damp_dist
    vel = vel + jnp.where(nxt < wall_min, wall_min - nxt, 0.0)
    vel = vel + jnp.where(nxt > wall_max, wall_max - nxt, 0.0)

    return ParticleState(
        pos=pos, vel=vel, C=C, mass=p.mass, density=density, pressure=pressure
    )
