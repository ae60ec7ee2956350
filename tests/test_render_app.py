"""TUI smoke + render parity tests (SURVEY.md §4.6)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluid_tpu import render, scene
from fluid_tpu.app import run as app_run
from fluid_tpu.config import default_2d


def test_histogram_matches_reference_binning():
    # console bin = floor(pos / viewport * console), skip out-of-range
    # (2d_multi.rs:449-458)
    pos = jnp.asarray(
        [[0.0, 0.0], [63.9, 63.9], [32.0, 32.0], [32.1, 32.1], [64.0, 10.0]],
        jnp.float32,
    )
    h = np.asarray(render.histogram(pos, jnp.asarray([64.0, 64.0]), (80, 40)))
    assert h.shape == (40, 80)
    assert h[0, 0] == 1
    assert h[39, 79] == 1
    assert h[20, 40] == 2  # both center particles share a bin
    assert h.sum() == 4  # x=64 is out of console range and skipped


def test_ascii_ramp_thresholds():
    # count -> char per 2d_multi.rs:465-474
    counts = np.asarray([[0, 1, 2, 3, 4, 5, 6, 7, 12]])
    (line,) = render.ascii_frame(counts)
    assert line == " .-=*%$##"


def test_render_nonempty_for_scene():
    cfg = default_2d()
    p, _ = scene.dam_break(jax.random.key(0), cfg, n=1024)
    lines = render.render(p)
    assert len(lines) == 40 and all(len(l) == 80 for l in lines)
    assert any(ch != " " for l in lines for ch in l)


def test_app_headless_smoke():
    out = io.StringIO()
    app_run(dim=2, n=256, frames=2, headless=True, out=out)
    text = out.getvalue()
    assert "--- frame 0 ---" in text and "--- frame 1 ---" in text
    assert "frame:" in text  # timing line
    # density render non-empty
    assert any(c in text for c in ".-=*%$#")


def test_app_headless_timing_overlay():
    out = io.StringIO()
    app_run(dim=2, n=128, frames=1, headless=True, timing=True, out=out)
    text = out.getvalue()
    for label in ("p2g 1", "p2g 2", "update", "g2p"):
        assert f"{label}:" in text


@pytest.mark.parametrize("shards", [2, 4])
def test_app_headless_sharded_smoke(shards):
    """--shards N: parallel.shard's x-slabs behind the reference's
    interactive loop (2d_multi.rs:518-539), on N virtual devices."""
    out = io.StringIO()
    p = app_run(dim=2, n=192, frames=2, headless=True, shards=shards, out=out)
    text = out.getvalue()
    assert "--- frame 1 ---" in text
    assert any(c in text for c in ".-=*%$#")
    assert p.pos.shape == (192, 2) and np.isfinite(np.asarray(p.pos)).all()
