#!/usr/bin/env python
"""Smoke test of the MLS-MPM frame on the GPU, through the normal entry
points, in one process.

Phases (any failure exits nonzero; nothing is printed as a result then):

1. device  — JAX must see a GPU; prints its kind, count, ``nvidia-smi`` name
             and power limit, the JAX version and ``XLA_FLAGS``.
2. app     — ``app.run`` headless, 2D and 3D at the reference N, default
             backend: frames render, the state stays finite.
3. parity  — dense on the card against the NumPy oracle (tests/oracle.py);
             sorted and tiled against dense on the card (3D, 20k particles);
             a ``Session`` snapshot/restore replay against the first run.
4. scale   — the 3d-1m scene through ``Session`` (3 frames) and batch-64 as
             a vmapped frame (2 frames): finite, particle count and mass
             conserved, positions inside ``boundary_clip``; compile seconds,
             s/frame and memory, each with the card's name and power limit.

``--four-cards`` runs only this phase instead:

5. four cards — ``parallel.shard.sharded_frame`` over 4 GPUs on a 1-D mesh,
             the 3d-1m scene as x-slabs, against single-card dense after 2
             substeps; each slab on its own device; migration lossless;
             then whole frames, timed beside single-card dense.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Tolerances.  Every f32 contraction pins ``Precision.HIGHEST`` (no TF32).
On the GPU the scatters are atomic adds whose summation order changes from
run to run, so results agree to float32 reordering, not bitwise:
  * dense vs oracle: tests/test_golden.py's bars (2e-5 after one substep,
    1e-3 after more);
  * sorted/tiled vs dense, sharded vs single-card, replay vs first run:
    max|dpos|, max|dvel| <= 1e-3 (bench.VERIFY_TOL).

Usage:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import io
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

ONE_STEP_TOL = 2e-5  # tests/test_golden.py, one substep
MULTI_STEP_TOL = 1e-3  # tests/test_golden.py, several substeps
ORACLE_N = 192  # tests/test_golden.py's scene size


def check(label: str, err: float, tol: float) -> None:
    """Print ``err`` beside ``tol``; raise unless ``err <= tol``."""
    ok = math.isfinite(err) and err <= tol
    print(f"{label}: err={err:.3e} tol={tol:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: error {err!r} exceeds tolerance {tol}")


def check_state(label: str, p, cfg, n: int) -> None:
    """Raise unless the state is finite, holds ``n`` particles of conserved
    total mass, and every position lies inside ``cfg.boundary_clip``."""
    import numpy as np

    pos = np.asarray(p.pos).reshape(-1, cfg.dim)
    vel = np.asarray(p.vel).reshape(-1, cfg.dim)
    mass = np.asarray(p.mass)
    problems = []
    if pos.shape[0] != n:
        problems.append(f"{pos.shape[0]} particles, expected {n}")
    if not (np.isfinite(pos).all() and np.isfinite(vel).all()):
        problems.append("non-finite state")
    if float(mass.sum(dtype=np.float64)) != float(n):
        problems.append(f"total mass {mass.sum(dtype=np.float64)} != {n}")
    lo, hi = (np.asarray(b, np.float32) for b in cfg.boundary_clip)
    if not ((pos >= lo).all() and (pos <= hi).all()):
        problems.append("positions outside boundary_clip")
    if problems:
        raise RuntimeError(f"{label}: " + "; ".join(problems))
    print(f"{label}: {n} particles finite, mass conserved, inside boundary_clip")


def oracle_parity(dim: int, substeps: int = 2, n: int = ORACLE_N) -> None:
    """Dense on the current device against the NumPy oracle, after each of
    ``substeps`` substeps, on tests/test_golden.py's random scene."""
    import jax
    import numpy as np

    from fluid_tpu import step
    from fluid_tpu.config import default_2d, default_3d
    from fluid_tpu.domain import make_domain
    from fluid_tpu.state import ParticleState
    from tests.oracle import OracleSim

    cfg = default_2d() if dim == 2 else default_3d()
    rng = np.random.default_rng(7)
    lo, hi = (18.0, 18.0, 18.0), (46.0, 46.0, 30.0)
    pos = np.stack([rng.uniform(lo[d], hi[d], n) for d in range(dim)], -1).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, dim)).astype(np.float32)
    C = rng.normal(0, 0.05, (n, dim, dim)).astype(np.float32)
    dom = make_domain(cfg)
    mp, ma = step.no_mouse()
    sub = jax.jit(lambda q: step.substep(q, cfg, dom, mp, ma)[0])
    oracle = OracleSim(cfg, pos, vel, C)
    p = ParticleState.create(pos, vel=vel, C=C)
    for k in range(1, substeps + 1):
        oracle.substep()
        p = sub(p)
        tol = ONE_STEP_TOL if k == 1 else MULTI_STEP_TOL
        for f in ("pos", "vel", "C", "density", "pressure"):
            err = float(np.abs(np.asarray(getattr(p, f)) - getattr(oracle, f)).max())
            check(f"parity {dim}D dense vs oracle, substep {k}, {f}", err, tol)


def phase_device():
    import os

    import jax

    from fluid_tpu.utils import platform

    devs = platform.require_gpu("this smoke test runs only on a GPU")
    smi = platform.nvidia_smi()
    print(f"device: platform={devs[0].platform} kind={devs[0].device_kind} count={len(devs)}")
    print(f"nvidia-smi name, power.limit: {smi}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    platform.setup_compile_cache()
    return devs, smi.splitlines()[0]


def phase_app():
    from fluid_tpu import app, scene
    from fluid_tpu.config import default_2d, default_3d

    for dim, cfg in ((2, default_2d()), (3, default_3d())):
        out = io.StringIO()
        t0 = time.perf_counter()
        p = app.run(dim=dim, n=scene.REFERENCE_N, frames=5, headless=True, out=out)
        wall = time.perf_counter() - t0
        text = out.getvalue()
        if "--- frame 4 ---" not in text or not any(c in text for c in ".-=*%$#"):
            raise RuntimeError(f"app {dim}D: frames did not render")
        check_state(f"app {dim}D", p, cfg, scene.REFERENCE_N)
        last = text[text.index("--- frame 4 ---"):].splitlines()
        print(f"app {dim}D: 5 frames in {wall:.3f} s (compile included); "
              f"last frame {last[-1]}")


def phase_parity():
    import jax
    import numpy as np

    import bench
    from fluid_tpu import scene, session

    for dim in (2, 3):
        oracle_parity(dim)
    errs = bench.verify_on_device(dim=3, n=20_000)
    for name, (ep, ev) in errs.items():
        check(f"parity 3D 20k {name} vs dense, 2 substeps, max|dpos|", ep, bench.VERIFY_TOL)
        check(f"parity 3D 20k {name} vs dense, 2 substeps, max|dvel|", ev, bench.VERIFY_TOL)

    # Session snapshot/restore replay (atomics: not bitwise on a GPU)
    cfg, p, dom = scene.reference_scene_3d(seed=0)
    sess = session.Session(cfg, dom, p)
    snap = sess.snapshot()
    sess.run(2)
    a = jax.tree.map(np.asarray, sess.particles())
    sess.restore(snap)
    sess.run(2)
    b = sess.particles()
    same = bool(np.array_equal(a.pos, np.asarray(b.pos)))
    print(f"replay 3D ref, 2 frames: bit-identical={same}")
    check("replay 3D ref max|dpos|", float(np.abs(a.pos - np.asarray(b.pos)).max()), bench.VERIFY_TOL)
    check("replay 3D ref max|dvel|", float(np.abs(a.vel - np.asarray(b.vel)).max()), bench.VERIFY_TOL)


def _report(label, card, compiled, compile_s, s_per_frame):
    import jax

    ma = compiled.memory_analysis()
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"{label} compile_s={compile_s:.3f} [{card}]")
    print(f"{label} s_per_frame={s_per_frame:.6f} [{card}]")
    print(f"{label} peak_bytes_in_use={peak} [{card}]")
    print(f"{label} memory_analysis: argument={ma.argument_size_in_bytes} "
          f"output={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
          f"alias={ma.alias_size_in_bytes} [{card}]")


def phase_scale(card: str):
    import jax

    import bench
    from fluid_tpu import step
    from fluid_tpu.session import Session

    # 3d-1m through the library's Session (default backend)
    n, frames = 1_000_000, 3
    cfg, p, dom = bench._make_scene(3, n)
    sess = Session(cfg, dom, p)
    t0 = time.perf_counter()
    compiled = sess.compile_run(frames)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.run(frames)
    sess.block_until_ready()
    spf = (time.perf_counter() - t0) / frames
    check_state(f"scale 3d-1m ({sess.backend}, {frames} frames)", sess.particles(), cfg, n)
    _report(f"scale 3d-1m {sess.backend}", card, compiled, compile_s, spf)

    # batch-64: 64 reference dams as one vmapped frame
    batch, n, frames = 64, 4096, 2
    cfg, p, dom = bench._make_scene(3, n, batch)
    mp, ma = step.no_mouse()
    fn = jax.vmap(lambda q: step.frame_body(q, cfg, dom, mp, ma))
    t0 = time.perf_counter()
    compiled = jax.jit(fn, donate_argnums=0).lower(p).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(frames):
        p = compiled(p)
    jax.block_until_ready(p)
    spf = (time.perf_counter() - t0) / frames
    check_state(f"scale batch-64 (dense vmap, {frames} frames)", p, cfg, batch * n)
    _report("scale batch-64 dense", card, compiled, compile_s, spf)


def phase_four_cards(card: str, n: int = 1_000_000, n_cards: int = 4):
    """Sharded dense x-slabs over ``n_cards`` devices against single-device
    dense on the same scene."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import bench
    from fluid_tpu import step
    from fluid_tpu.parallel import shard

    devs = jax.devices()
    if len(devs) < n_cards:
        raise RuntimeError(f"--four-cards needs {n_cards} devices, have {len(devs)}")
    devs = devs[:n_cards]
    cfg, p, dom = bench._make_scene(3, n)
    mesh = Mesh(np.array(devs), (shard.AXIS,))
    spec = shard.default_spec(dom, n_cards, n)
    lp = shard.shard_particles(p, spec, mesh)

    # each slab on its own device, holding exactly the particles it owns
    owner = np.clip(
        (np.floor(np.asarray(p.pos)[:, 0]).astype(np.int64) - dom.origin[0]) // spec.slab,
        0, n_cards - 1,
    )
    for s in lp.alive.addressable_shards:
        k = s.index[0].start // spec.capacity
        if s.device != devs[k]:
            raise RuntimeError(f"slab {k} is on {s.device}, expected {devs[k]}")
        held, want = int(np.asarray(s.data).sum()), int((owner == k).sum())
        if held != want:
            raise RuntimeError(f"slab {k} holds {held} particles, owns {want}")
        print(f"four-cards slab {k}: {held} particles on {s.device}")

    substeps = 2
    mp, ma = step.no_mouse()
    t0 = time.perf_counter()
    lp = shard.sharded_frame(lp, cfg, spec, mesh, mp, ma, substeps=substeps)
    jax.block_until_ready(lp)
    print(f"four-cards {substeps} substeps (compile included): "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    uid = np.asarray(lp.uid)[np.asarray(lp.alive)]
    if len(uid) != n or len(np.unique(uid)) != n:
        raise RuntimeError(f"migration lost particles: {len(np.unique(uid))} of {n} alive")
    print(f"four-cards migration lossless: {n} particles alive exactly once")
    got = shard.gather_particles(lp, n)

    ref = jax.jit(lambda q: jax.lax.fori_loop(
        0, substeps, lambda _, s: step.substep(s, cfg, dom, mp, ma)[0], q
    ))(jax.device_put(p, devs[0]))
    ep, ev = bench.max_abs_err(got, ref)
    check(f"four-cards sharded vs 1-card dense, {substeps} substeps, max|dpos|", ep, bench.VERIFY_TOL)
    check(f"four-cards sharded vs 1-card dense, {substeps} substeps, max|dvel|", ev, bench.VERIFY_TOL)
    check_state("four-cards", got, cfg, n)

    # whole frames: the second of each is timed (the first compiles)
    lp = shard.sharded_frame(lp, cfg, spec, mesh, mp, ma)
    jax.block_until_ready(lp)
    t0 = time.perf_counter()
    lp = shard.sharded_frame(lp, cfg, spec, mesh, mp, ma)
    jax.block_until_ready(lp)
    print(f"four-cards sharded s_per_frame={time.perf_counter() - t0:.6f} "
          f"({n_cards} devices) [{card}]")
    check_state("four-cards after 2 more frames", shard.gather_particles(lp, n), cfg, n)
    q = step.frame(ref, cfg, dom, mp, ma)
    jax.block_until_ready(q)
    t0 = time.perf_counter()
    jax.block_until_ready(step.frame(q, cfg, dom, mp, ma))
    print(f"four-cards 1-card dense s_per_frame={time.perf_counter() - t0:.6f} "
          f"[{card}]")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded phase")
    args = ap.parse_args(argv)

    devs, card = phase_device()
    if args.four_cards:
        phase_four_cards(card)
    else:
        phase_app()
        phase_parity()
        phase_scale(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))


if __name__ == "__main__":
    main()
