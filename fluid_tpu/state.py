"""SoA simulation state pytrees.

The reference stores AoS ``Particle`` structs in hash-map chunks
(``2d_multi.rs:35-41,52``) and AoS ``Cell`` structs in a dense Vec
(``2d_multi.rs:43-48,53``).  On an accelerator the idiomatic layout is
structure-of-arrays with static shapes: contiguous ``[N, D]`` arrays keep
memory access coalesced and XLA fusion trivial.

``density`` and ``pressure`` — intermediates inside the reference's ``p2g_2``
(``2d_multi.rs:195-214``) — are first-class state here, per the north-star API
requirement (BASELINE.json: "same scene/state API (particle positions,
velocities, densities, pressures)").

The ``Cell.is_computed`` dedup flag (``2d_multi.rs:47``) has no equivalent:
the dense vectorized grid update normalizes each cell exactly once
(SURVEY.md quirk Q1).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ParticleState:
    """Fixed-capacity SoA particle arrays.

    pos:      [N, D] float32 — world position
    vel:      [N, D] float32
    C:        [N, D, D] float32 — APIC affine-momentum matrix
              (``Particle.affine_momentum``, ``2d_multi.rs:39``)
    mass:     [N] float32
    density:  [N] float32 — gathered in p2g_2 (``2d_multi.rs:195-209``)
    pressure: [N] float32 — Tait EOS (``2d_multi.rs:211-214``)
    """

    pos: jax.Array
    vel: jax.Array
    C: jax.Array
    mass: jax.Array
    density: jax.Array
    pressure: jax.Array

    @property
    def n(self) -> int:
        return self.pos.shape[-2]

    @property
    def dim(self) -> int:
        return self.pos.shape[-1]

    @staticmethod
    def zeros(n: int, dim: int, dtype=jnp.float32) -> "ParticleState":
        return ParticleState(
            pos=jnp.zeros((n, dim), dtype),
            vel=jnp.zeros((n, dim), dtype),
            C=jnp.zeros((n, dim, dim), dtype),
            mass=jnp.zeros((n,), dtype),
            density=jnp.zeros((n,), dtype),
            pressure=jnp.zeros((n,), dtype),
        )

    @staticmethod
    def create(pos, vel=None, C=None, mass=None) -> "ParticleState":
        """Build from positions; remaining fields default to the reference's
        seeding values (vel=0, C=0, mass=1 — ``2d_multi.rs:502-512``)."""
        pos = jnp.asarray(pos, jnp.float32)
        n, dim = pos.shape
        return ParticleState(
            pos=pos,
            vel=jnp.zeros((n, dim), jnp.float32) if vel is None else jnp.asarray(vel, jnp.float32),
            C=jnp.zeros((n, dim, dim), jnp.float32) if C is None else jnp.asarray(C, jnp.float32),
            mass=jnp.ones((n,), jnp.float32) if mass is None else jnp.asarray(mass, jnp.float32),
            density=jnp.zeros((n,), jnp.float32),
            pressure=jnp.zeros((n,), jnp.float32),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GridState:
    """Dense background-grid fields over the padded domain.

    mass: [*shape] float32 — cell mass (``Cell.mass``, ``2d_multi.rs:46``)
    vel:  [*shape, D] float32 — cell momentum during P2G, velocity after
          ``update_grid`` (``Cell.vel``, ``2d_multi.rs:45``)
    """

    mass: jax.Array
    vel: jax.Array

    @staticmethod
    def zeros(shape: Tuple[int, ...], dtype=jnp.float32) -> "GridState":
        return GridState(
            mass=jnp.zeros(shape, dtype),
            vel=jnp.zeros((*shape, len(shape)), dtype),
        )
