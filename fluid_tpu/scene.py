"""Scene construction — dam-break seeding and batched randomized scenes.

Parity with the reference's ``main`` seeding (``2d_multi.rs:502-512`` /
``3d_multi.rs:525-536``): 4096 unit-mass particles uniformly random in
``[16, 48]^2`` (2D) or ``[16, 32]^3`` (3D), zero velocity, zero affine
momentum, then ``set_rect((0,0),(64,64))``.

The reference's ``add_particle``/hash-map insertion (``2d_multi.rs:104-108``)
has no equivalent: scenes are built as whole arrays via ``jax.random`` (a
counter-based, reproducible PRNG — seeding differences vs the reference's
``rand::rng()`` are immaterial since the reference is unseeded/entropy-based).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .config import Config, default_2d, default_3d
from .domain import Domain, make_domain
from .state import ParticleState

# Reference seeding boxes (2d_multi.rs:504-507, 3d_multi.rs:527-531).
SEED_BOX_2D = ((16.0, 16.0), (48.0, 48.0))
SEED_BOX_3D = ((16.0, 16.0, 16.0), (32.0, 32.0, 32.0))
REFERENCE_N = 4096


def dam_break(
    key: jax.Array,
    cfg: Config,
    n: int = REFERENCE_N,
    box: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None,
) -> Tuple[ParticleState, Domain]:
    """Uniform-random block of fluid, reference-style.

    Returns the particle state and the static domain (the ``set_rect`` analog,
    ``2d_multi.rs:513``).
    """
    if box is None:
        box = SEED_BOX_2D if cfg.dim == 2 else SEED_BOX_3D
    lo = jnp.asarray(box[0], jnp.float32)
    hi = jnp.asarray(box[1], jnp.float32)
    pos = jax.random.uniform(key, (n, cfg.dim), jnp.float32, lo, hi)
    return ParticleState.create(pos), make_domain(cfg)


def batched_dam_break(
    key: jax.Array,
    cfg: Config,
    batch: int,
    n: int = REFERENCE_N,
    jitter: float = 8.0,
) -> Tuple[ParticleState, Domain]:
    """A [batch, N, ...] stack of randomized dam-break scenes for the vmapped
    parameter-sweep configuration (BASELINE.json config 5: 64 randomized 3D
    scenes).  Each scene's seed box is randomly translated by up to ``jitter``
    world units (kept inside the boundary)."""
    box = SEED_BOX_2D if cfg.dim == 2 else SEED_BOX_3D
    lo = jnp.asarray(box[0], jnp.float32)
    hi = jnp.asarray(box[1], jnp.float32)
    clip_lo = jnp.asarray(cfg.boundary_clip[0], jnp.float32)
    clip_hi = jnp.asarray(cfg.boundary_clip[1], jnp.float32)

    k_shift, k_pos = jax.random.split(key)
    shift = jax.random.uniform(k_shift, (batch, cfg.dim), jnp.float32, -jitter, jitter)
    shift = jnp.clip(shift, clip_lo - lo, clip_hi - hi)
    pos = jax.random.uniform(k_pos, (batch, n, cfg.dim), jnp.float32, lo, hi)
    pos = pos + shift[:, None, :]
    state = jax.vmap(ParticleState.create)(pos)
    return state, make_domain(cfg)


def add_particles(state: ParticleState, pos, vel=None, C=None, mass=None) -> ParticleState:
    """Append particles to a scene (the ``add_particle`` analog,
    ``2d_multi.rs:104-108``) — returns a NEW fixed-size state; call while
    building scenes, not inside jit (shapes change)."""
    extra = ParticleState.create(pos, vel=vel, C=C, mass=mass)
    return jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0), state, extra)


def reference_scene_2d(seed: int = 0, n: int = REFERENCE_N):
    """The exact reference 2D app scene (config + particles + domain)."""
    cfg = default_2d()
    p, dom = dam_break(jax.random.key(seed), cfg, n)
    return cfg, p, dom


def reference_scene_3d(seed: int = 0, n: int = REFERENCE_N):
    """The exact reference 3D app scene (config + particles + domain)."""
    cfg = default_3d()
    p, dom = dam_break(jax.random.key(seed), cfg, n)
    return cfg, p, dom
