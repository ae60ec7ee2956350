"""Fused simulation step.

The reference's ``Simulation::step`` (``2d_multi.rs:110-134``) runs 31 host-
side substeps per frame, each calling five phases with ``Instant`` timing in
between.  Here the whole frame is ONE jitted XLA program: the five phases fuse
into a single substep function and ``lax.fori_loop`` runs the substeps on
device — zero host round-trips in the inner loop (SURVEY.md §7.3 hard part 5).

Three interchangeable transfer backends plug into this frame loop, all plain
JAX/XLA:
  "dense"  — ops.transfer scatter/gather (correctness reference)
  "sorted" — ops.sorted_transfer sort + segment-sum
  "tiled"  — ops.tiled_transfer sort + per-tile contractions
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .config import Config
from .domain import Domain
from .state import GridState, ParticleState
from .ops import transfer


def _get_backend(name: str):
    if name == "dense":
        return transfer
    if name == "sorted":
        from .ops import sorted_transfer

        return sorted_transfer
    if name == "tiled":
        from .ops import tiled_transfer

        return tiled_transfer
    raise ValueError(f"unknown transfer backend {name!r}")


def substep(
    p: ParticleState,
    cfg: Config,
    domain: Domain,
    mouse_pos: jnp.ndarray,
    mouse_active: jnp.ndarray,
    backend: str = "dense",
) -> Tuple[ParticleState, GridState]:
    """One MLS-MPM substep: p2g_1 -> p2g_2 -> grid_update -> g2p.

    Matches one iteration of the reference's substep loop
    (``2d_multi.rs:111-133``).  Returns the new particle state and the
    post-update grid (handy for diagnostics/tests; XLA dead-code-eliminates
    it when unused).
    """
    ops = _get_backend(backend)
    if hasattr(ops, "substep"):
        # Backend provides a fused substep (e.g. the sorted backend sorts
        # once and runs every phase on the cell-ordered layout).
        return ops.substep(p, cfg, domain, mouse_pos, mouse_active)
    grid = ops.p2g_1(p, cfg, domain)
    grid, density, pressure = ops.p2g_2(p, grid, cfg, domain)
    grid = ops.grid_update(grid, cfg)
    p = ops.g2p(p, grid, cfg, domain, mouse_pos, mouse_active, density, pressure)
    return p, grid


def frame_body(
    p: ParticleState,
    cfg: Config,
    domain: Domain,
    mouse_pos: jnp.ndarray,
    mouse_active: jnp.ndarray,
    backend: str = "dense",
    substeps: int | None = None,
) -> ParticleState:
    """Unjitted frame body (``cfg.iterations`` substeps under fori_loop) —
    compose under your own jit/vmap/shard; or use ``frame`` for the default
    jitted entry point."""

    def body(_, p):
        new_p, _ = substep(p, cfg, domain, mouse_pos, mouse_active, backend)
        return new_p

    n = cfg.iterations if substeps is None else substeps
    return jax.lax.fori_loop(0, n, body, p)


@functools.partial(jax.jit, static_argnames=("cfg", "domain", "backend"))
def frame(
    p: ParticleState,
    cfg: Config,
    domain: Domain,
    mouse_pos: jnp.ndarray,
    mouse_active: jnp.ndarray,
    backend: str = "dense",
) -> ParticleState:
    """One frame = ``cfg.iterations`` substeps in a single XLA program.

    Parity with ``Simulation::step`` (``2d_multi.rs:110-134``).  Inputs are
    NOT donated: users legitimately re-run a frame from the same state
    (backend comparisons, branching rollouts).  The in-place perf path is
    ``session.Session`` (which donates its persistent state).
    """
    return frame_body(p, cfg, domain, mouse_pos, mouse_active, backend)


def no_mouse(dtype=jnp.float32) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mouse_pos, mouse_active) inputs for a frame without interaction."""
    return jnp.zeros((2,), dtype), jnp.asarray(False)


def mouse(pos_xy, dtype=jnp.float32) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mouse_pos, mouse_active) inputs for a frame with the mouse at pos_xy
    (world coordinates; xy plane in 3D, ``3d_multi.rs:305-310``)."""
    return jnp.asarray(pos_xy, dtype), jnp.asarray(True)
