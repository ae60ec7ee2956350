"""Backend equivalence: sorted segment-sum and tiled contractions vs dense
scatter on random states (SURVEY.md §4.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluid_tpu import scene, step
from fluid_tpu.config import default_2d, default_3d
from fluid_tpu.domain import make_domain


def _case(make, backend):
    """The reference config, or for tiled (whose step-level spec covers
    every tile of the domain) a compact world with the same physics, seeded
    near rest density."""
    cfg = make()
    if backend != "tiled":
        return cfg, None
    w = 32.0 if cfg.dim == 2 else 16.0
    cfg = cfg.replace(
        boundary_clip=((0.0,) * cfg.dim, (w,) * cfg.dim), grid_res=int(w) // 2
    )
    return cfg, ((w / 4,) * cfg.dim, (3 * w / 4,) * cfg.dim)


def _rand_state(cfg, n, seed, box=None):
    key = jax.random.key(seed)
    p, dom = scene.dam_break(key, cfg, n=n, box=box)
    if box is not None:
        dom = make_domain(cfg, halo_cells=4)
    k1, k2 = jax.random.split(key)
    p.vel = jax.random.normal(k1, p.vel.shape) * 0.4
    p.C = jax.random.normal(k2, p.C.shape) * 0.05
    return p, dom


@pytest.mark.parametrize("make", [default_2d, default_3d], ids=["2d", "3d"])
@pytest.mark.parametrize("backend", ["sorted", "tiled"])
def test_backend_matches_dense_one_substep(make, backend):
    cfg, box = _case(make, backend)
    p, dom = _rand_state(cfg, 512, seed=0, box=box)
    mp, ma = step.no_mouse()

    def run(backend):
        return jax.jit(lambda p: step.substep(p, cfg, dom, mp, ma, backend=backend))(p)

    a, ga = run("dense")
    b, gb = run(backend)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.C), np.asarray(b.C), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.density), np.asarray(b.density), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.pressure), np.asarray(b.pressure), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ga.mass), np.asarray(gb.mass), atol=1e-5)


@pytest.mark.parametrize("backend", ["sorted", "tiled"])
def test_backend_matches_dense_full_frame(backend):
    cfg, box = _case(default_2d, backend)
    p, dom = _rand_state(cfg, 1024, seed=3, box=box)
    # step.frame donates its input buffers — copy for the second run.
    p2 = jax.tree.map(jnp.copy, p)
    a = step.frame(p, cfg, dom, *step.no_mouse(), "dense")
    b = step.frame(p2, cfg, dom, *step.no_mouse(), backend)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=1e-3)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=1e-3)


@pytest.mark.parametrize("backend", ["tiled"])
def test_fused_backend_through_step_frame(backend):
    """The public step.frame dispatch path (the one the app and driver use)
    must route to the backend's fused substep and match dense.  Reduced
    iterations + a compact domain keep the CPU compile small."""
    from fluid_tpu.domain import make_domain

    cfg = default_2d().replace(
        iterations=3, boundary_clip=((0.0, 0.0), (32.0, 32.0)), grid_res=16
    )
    p, _ = scene.dam_break(
        jax.random.key(7), cfg, n=512, box=((8.0, 8.0), (24.0, 24.0))
    )
    k1, k2 = jax.random.split(jax.random.key(8))
    p.vel = jax.random.normal(k1, p.vel.shape) * 0.4
    p.C = jax.random.normal(k2, p.C.shape) * 0.05
    dom = make_domain(cfg, halo_cells=4)
    p2 = jax.tree.map(jnp.copy, p)
    a = step.frame(p, cfg, dom, *step.no_mouse(), "dense")
    b = step.frame(p2, cfg, dom, *step.no_mouse(), backend)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=1e-3)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=1e-3)


@pytest.mark.parametrize("backend", ["sorted", "tiled"])
def test_backend_with_mouse(backend):
    cfg, box = _case(default_2d, backend)
    p, dom = _rand_state(cfg, 256, seed=5, box=box)
    mp, ma = step.mouse((16.0, 16.0) if box else (30.0, 30.0))
    a, _ = jax.jit(lambda p: step.substep(p, cfg, dom, mp, ma, backend="dense"))(p)
    b, _ = jax.jit(lambda p: step.substep(p, cfg, dom, mp, ma, backend=backend))(p)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=1e-5)
