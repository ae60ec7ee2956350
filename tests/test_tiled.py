"""Tiled-backend equivalence vs dense (SURVEY.md §4.4).

Uses shrunken domains (smaller boundary box) so the dense tile structure
stays small enough for fast CPU compiles; the physics path is identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluid_tpu import step
from fluid_tpu.config import default_2d, default_3d
from fluid_tpu.domain import make_domain
from fluid_tpu.ops import tiled_transfer as tt
from fluid_tpu.state import ParticleState


def _small_case(dim, n, seed):
    base = default_2d() if dim == 2 else default_3d()
    cfg = base.replace(
        boundary_clip=(tuple(0.0 for _ in range(dim)), tuple(32.0 for _ in range(dim))),
        grid_res=16,
    )
    # tight halo: identical physics, far fewer tiles (fast CPU compiles)
    dom = make_domain(cfg, halo_cells=4)
    key = jax.random.key(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    pos = jax.random.uniform(k1, (n, dim), jnp.float32, 8.0, 24.0)
    p = ParticleState.create(pos)
    p.vel = jax.random.normal(k2, p.vel.shape) * 0.4
    p.C = jax.random.normal(k3, p.C.shape) * 0.05
    return cfg, p, dom


# 3D is slow-marked: the 3D CPU compile dominates this file; 2D plus
# the fused-frame dispatch test keep the tiled backend covered by default.
@pytest.mark.parametrize(
    "dim", [2, pytest.param(3, marks=pytest.mark.slow)]
)
def test_tiled_matches_dense_one_substep(dim):
    cfg, p, dom = _small_case(dim, 384, seed=0)
    spec = tt.TileSpec(tile=4, cap=64)
    assert int(tt.overflow_count(p.pos, dom, spec)) == 0
    mp, ma = step.no_mouse()
    a, ga = jax.jit(lambda q: step.substep(q, cfg, dom, mp, ma, backend="dense"))(p)
    b, gb = jax.jit(lambda q: tt.substep(q, cfg, dom, mp, ma, spec))(p)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.C), np.asarray(b.C), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.density), np.asarray(b.density), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ga.mass), np.asarray(gb.mass), atol=1e-4)


def test_tiled_multi_substep_trajectory():
    cfg, p, dom = _small_case(2, 512, seed=1)
    spec = tt.TileSpec(tile=4, cap=96)
    mp, ma = step.no_mouse()

    @jax.jit
    def run_tiled(p):
        def body(_, q):
            return tt.substep(q, cfg, dom, mp, ma, spec)[0]

        return jax.lax.fori_loop(0, 8, body, p)

    @jax.jit
    def run_dense(p):
        def body(_, q):
            return step.substep(q, cfg, dom, mp, ma)[0]

        return jax.lax.fori_loop(0, 8, body, p)

    a, b = run_dense(p), run_tiled(p)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=1e-3)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=1e-3)


def test_tiled_with_mouse():
    cfg, p, dom = _small_case(2, 256, seed=2)
    spec = tt.TileSpec(tile=4, cap=64)
    mp, ma = step.mouse((16.0, 16.0))
    a, _ = jax.jit(lambda q: step.substep(q, cfg, dom, mp, ma, backend="dense"))(p)
    b, _ = jax.jit(lambda q: tt.substep(q, cfg, dom, mp, ma, spec))(p)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=1e-5)


def test_overflow_freezes_not_corrupts():
    # cap=8 with 64 particles jammed into one tile: overflowing particles
    # must pass through frozen (old state), never garbage.
    cfg, p, dom = _small_case(2, 64, seed=3)
    pos = jnp.full((64, 2), 10.5, jnp.float32) + jax.random.uniform(
        jax.random.key(9), (64, 2), jnp.float32, 0.0, 1.0
    )
    p = ParticleState.create(pos)
    spec = tt.TileSpec(tile=4, cap=8)
    n_over = int(tt.overflow_count(p.pos, dom, spec))
    assert n_over > 0
    mp, ma = step.no_mouse()
    b, _ = jax.jit(lambda q: tt.substep(q, cfg, dom, mp, ma, spec))(p)
    assert np.isfinite(np.asarray(b.pos)).all()
    # frozen particles keep their exact old position
    moved = np.abs(np.asarray(b.pos) - np.asarray(p.pos)).max(axis=1)
    assert (moved == 0.0).sum() >= n_over


def test_active_budget_compaction():
    # with a tight active-tile budget, occupied tiles <= budget => exact match
    cfg, p, dom = _small_case(2, 256, seed=4)
    spec_dense = tt.TileSpec(tile=4, cap=64, active=None)
    b = tt.bin_particles(p.pos, dom, spec_dense)
    n_occupied = int((np.asarray(b["start"][1:] - b["start"][:-1]) > 0).sum())
    spec = tt.TileSpec(tile=4, cap=64, active=n_occupied + 2)
    assert int(tt.overflow_count(p.pos, dom, spec)) == 0
    mp, ma = step.no_mouse()
    a, _ = jax.jit(lambda q: step.substep(q, cfg, dom, mp, ma, backend="dense"))(p)
    c, _ = jax.jit(lambda q: tt.substep(q, cfg, dom, mp, ma, spec))(p)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(c.pos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(c.vel), atol=1e-5)


def test_preserve_order_false_same_physics():
    # sorted-order output must be a permutation of the order-preserving output
    cfg, p, dom = _small_case(2, 384, seed=6)
    spec = tt.TileSpec(tile=4, cap=64)
    mp, ma = step.no_mouse()
    a, _ = jax.jit(lambda q: tt.substep(q, cfg, dom, mp, ma, spec))(p)
    b, _ = jax.jit(
        lambda q: tt.substep(q, cfg, dom, mp, ma, spec, preserve_order=False)
    )(p)
    ka = np.lexsort(np.asarray(a.pos).T)
    kb = np.lexsort(np.asarray(b.pos).T)
    np.testing.assert_allclose(
        np.asarray(a.pos)[ka], np.asarray(b.pos)[kb], atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(a.vel)[ka], np.asarray(b.vel)[kb], atol=1e-6
    )
    assert float(b.mass.sum()) == p.n


def test_strict_mode_matches_when_no_overflow():
    cfg, p, dom = _small_case(2, 384, seed=7)
    spec = tt.TileSpec(tile=4, cap=64, strict=True)
    assert int(tt.overflow_count(p.pos, dom, spec)) == 0
    mp, ma = step.no_mouse()
    a, _ = jax.jit(lambda q: tt.substep(q, cfg, dom, mp, ma, tt.TileSpec(tile=4, cap=64)))(p)
    b, _ = jax.jit(lambda q: tt.substep(q, cfg, dom, mp, ma, spec))(p)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
    np.testing.assert_array_equal(np.asarray(a.vel), np.asarray(b.vel))
