"""Session (persistent-state frame driver) — the public interactive loop.

Every test runs on each transfer backend: state held across frames,
``run(k)`` as one program, snapshot/restore replay, and the device-side
histogram, each against the per-frame ``step.frame`` path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluid_tpu import render, scene, step
from fluid_tpu.config import default_2d
from fluid_tpu.session import Session, default_backend

BACKENDS = ["dense", "sorted", "tiled"]


def _case(iterations=2, n=512):
    # compact domain (32^2, 16-cell chunks) keeps the tiled backend's
    # all-tiles default spec small
    cfg = default_2d().replace(
        iterations=iterations,
        boundary_clip=((0.0, 0.0), (32.0, 32.0)),
        grid_res=16,
    )
    from fluid_tpu.domain import make_domain

    p, _ = scene.dam_break(
        jax.random.key(0), cfg, n=n, box=((8.0, 8.0), (24.0, 24.0))
    )
    return cfg, p, make_domain(cfg, halo_cells=4)


def test_default_backend_is_platform_appropriate():
    # the dense reference on every device
    assert default_backend() == "dense"


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_matches_step_frame_across_frames(backend):
    cfg, p, dom = _case()
    p2 = jax.tree.map(jnp.copy, p)
    sess = Session(cfg, dom, p, backend=backend)
    for _ in range(3):
        sess.frame()
    got = sess.particles()
    for _ in range(3):
        p2 = step.frame(p2, cfg, dom, *step.no_mouse(), backend)
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(p2.pos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.vel), np.asarray(p2.vel), atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_fused_run_matches_per_frame(backend):
    # Session.run(k) fuses k frames into ONE device program; it must match
    # k frame() calls (same frame body under an outer fori_loop).
    cfg, p, dom = _case()
    p2 = jax.tree.map(jnp.copy, p)
    sa = Session(cfg, dom, p, backend=backend)
    for _ in range(3):
        sa.frame()
    sb = Session(cfg, dom, p2, backend=backend)
    sb.compile_run(3)  # AOT path: compile off the clock, run uses it
    sb.run(3)
    qa, qb = sa.particles(), sb.particles()
    np.testing.assert_allclose(np.asarray(qa.pos), np.asarray(qb.pos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(qa.vel), np.asarray(qb.vel), atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_histogram_matches_render(backend):
    cfg, p, dom = _case()
    sess = Session(cfg, dom, p, backend=backend)
    sess.frame()
    hist = np.asarray(sess.histogram(render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE))
    ref = np.asarray(
        render.histogram(
            sess.particles().pos,
            jnp.asarray(render.DEFAULT_VIEWPORT, jnp.float32),
            render.DEFAULT_CONSOLE,
        )
    )
    np.testing.assert_array_equal(hist, ref)
    assert hist.sum() == 512  # every particle lands inside the console


def test_session_dense_backend_same_api():
    cfg, p, dom = _case()
    sess = Session(cfg, dom, p, backend="dense")
    sess.frame(step.mouse((32.0, 32.0)))
    out = sess.particles()
    assert np.isfinite(np.asarray(out.pos)).all()
    lines = sess.render(render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE)
    assert len(lines) == render.DEFAULT_CONSOLE[1]


def test_session_rejects_unknown_backend():
    cfg, p, dom = _case()
    with pytest.raises(ValueError, match="unknown transfer backend"):
        Session(cfg, dom, p, backend="stream")


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_snapshot_restore_replays_bit_identical(backend):
    """snapshot/restore replays the SAME span through the warm program —
    bit-identical on the CPU, whose scatters sum in a fixed order."""
    cfg, p, dom = _case()
    cfg = cfg.replace(iterations=3)
    sess = Session(cfg, dom, p, backend=backend)
    sess.frame()
    snap = sess.snapshot()
    sess.run(2)
    a = np.asarray(sess.particles().pos)
    sess.restore(snap)
    sess.run(2)
    b = np.asarray(sess.particles().pos)
    np.testing.assert_array_equal(a, b)
    # the snapshot survives a second restore (run donates its input buffers)
    sess.restore(snap)
    sess.run(2)
    np.testing.assert_array_equal(a, np.asarray(sess.particles().pos))
