#!/usr/bin/env python
"""Benchmark harness — the five BASELINE.json configs on one GPU.

Every config races the XLA transfer backends (dense, sorted, tiled).  Before
any config runs, sorted and tiled are verified against dense on the device.
Prints one JSON line per config, the headline config last:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

``vs_baseline`` divides by the measured serial-CPU denominator in
BASELINE_MEASURED.json (the identical-semantics C++ engine, since the
reference is an unbenchmarked serial Rust binary — SURVEY.md §6).

Large-N configs use rest-density-filled scenes in proportionally larger
domains ("full occupancy", BASELINE.json config 4): cramming 1M particles
into the fixed 64-unit reference box would start the fluid at 244x rest
density, which is a pressure bomb, not a benchmark.

A run that finds no GPU fails unless ``--platform cpu`` is given.

Usage:
  python bench.py                      # headline: 3D 1M
  python bench.py --config all         # all five configs
  python bench.py --platform cpu --quick --config 2d-ref
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

BACKENDS = ("dense", "sorted", "tiled")

CONFIGS = {
    # name: (dim, particles, frames, batch, baseline_key)
    "2d-ref": (2, 4096, 20, None, "2d_reference_frame"),
    "3d-ref": (3, 4096, 10, None, "3d_reference_frame"),
    "2d-100k": (2, 100_000, 5, None, "2d_100k"),
    "3d-1m": (3, 1_000_000, 3, None, "3d_1m"),
    # 64 reference dams as one vmapped frame
    "batch-64": (3, 4096, 3, 64, "3d_reference_frame"),
}

# sorted/tiled must match dense within this after VERIFY_SUBSTEPS substeps
VERIFY_TOL = 1e-3
VERIFY_SUBSTEPS = 2


def _load_baseline():
    path = ROOT / "BASELINE_MEASURED.json"
    if path.exists():
        return json.loads(path.read_text())["results"]
    return {}


def _make_scene(dim, n, batch=None):
    """Reference config for reference-N; scaled rest-density box otherwise."""
    import jax
    import jax.numpy as jnp

    from fluid_tpu import scene
    from fluid_tpu.config import default_2d, default_3d
    from fluid_tpu.domain import make_domain
    from fluid_tpu.state import ParticleState

    base = default_2d() if dim == 2 else default_3d()
    if n <= scene.REFERENCE_N:
        cfg = base
        if batch:
            p, _ = scene.batched_dam_break(jax.random.key(0), cfg, batch, n=n)
        else:
            p, _ = scene.dam_break(jax.random.key(0), cfg, n=n)
        # tight halo: identical physics, far fewer grid cells (tested)
        return cfg, p, make_domain(cfg, halo_cells=4)

    # scaled domain: fluid box at rest density + ~15% margin around it
    side = (n / base.rest_density) ** (1.0 / dim)
    world = math.ceil(side * 1.15)
    cfg = base.replace(
        boundary_clip=(tuple(0.0 for _ in range(dim)), (float(world),) * dim)
    )
    dom = make_domain(cfg, halo_cells=4)
    lo = (world - side) / 2
    key = jax.random.key(0)
    pos = jax.random.uniform(key, (n, dim), jnp.float32, lo, lo + side)
    p = ParticleState.create(pos)
    return cfg, p, dom


def _tiled_spec(cfg, dom, n, batch=None):
    from fluid_tpu.ops import tiled_transfer as tt

    T = 4
    per_tile = cfg.rest_density * T**cfg.dim
    # batched reference dams compress hardest at the shared floor
    cap_f = 3.0 if batch else 2.5
    cap = max(32, -(-int(per_tile * cap_f) // 32) * 32)
    # rest-density scenes occupy ~n/per_tile tiles + a surface layer; the
    # fluid expands into the domain margin while settling (occupied tiles
    # grow ~1.45x initial at 3d-1m full-occupancy scenes, but reference-box
    # dams spread across the whole floor: batch-64's scenes reach 387
    # occupied tiles, 6x the estimate, within 5 frames).  The overflow
    # checks before and after a run guard the result.
    factor = 8.0 if n <= 4096 else 1.8
    occupied = max(64, int(n / max(per_tile, 1.0) * factor))
    active = min(-(-occupied // 64) * 64, math.prod(s // T for s in dom.shape))
    # strict: callers check overflow_count == 0 before and after a run
    return tt.TileSpec(tile=T, cap=cap, active=active, strict=True)


def _tiled_overflow(p, dom, spec, batch):
    from fluid_tpu.ops import tiled_transfer as tt

    if batch:
        return max(int(tt.overflow_count(p.pos[i], dom, spec)) for i in range(batch))
    return int(tt.overflow_count(p.pos, dom, spec))


def _frame_fn(cfg, dom, backend, n, batch=None):
    """The unjitted one-frame function the bench times, and the tiled spec
    (None for the other backends)."""
    import jax

    from fluid_tpu import step
    from fluid_tpu.ops import tiled_transfer as tt

    mp, ma = step.no_mouse()
    if backend == "tiled":
        spec = _tiled_spec(cfg, dom, n, batch)

        def frame_fn(q):
            return jax.lax.fori_loop(
                0, cfg.iterations,
                lambda _, s: tt.substep(s, cfg, dom, mp, ma, spec, preserve_order=False)[0],
                q,
            )

        return frame_fn, spec
    return (lambda q: step.frame_body(q, cfg, dom, mp, ma, backend)), None


def _fits(compiled):
    """(fits, bytes needed) from XLA's memory analysis of ``compiled``
    against the device's memory limit (always fits where the device
    reports no limit)."""
    import jax

    ma = compiled.memory_analysis()
    need = (
        ma.argument_size_in_bytes + ma.output_size_in_bytes
        + ma.temp_size_in_bytes - ma.alias_size_in_bytes
    )
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return (limit is None or need <= limit), need


def bench_backend(cfg, p, dom, frames, backend, batch=None):
    """Time ``frames`` frames of one backend after one warm-up frame.

    Returns a dict: particle-steps/s, s/frame, compile seconds and the
    bytes XLA's memory analysis says the frame program needs; or
    ``{"skipped": reason}`` when the program does not fit the device."""
    import jax
    import jax.numpy as jnp

    n = p.pos.shape[-2]
    frame_fn, spec = _frame_fn(cfg, dom, backend, n, batch)
    if spec is not None:
        over = _tiled_overflow(p, dom, spec, batch)
        if over:
            raise RuntimeError(f"tiled spec overflow at t=0: {over} particles")
    fn = jax.vmap(frame_fn) if batch else frame_fn
    t0 = time.perf_counter()
    compiled = jax.jit(fn, donate_argnums=0).lower(p).compile()
    compile_s = time.perf_counter() - t0
    fits, need = _fits(compiled)
    if not fits:
        return {"skipped": f"needs {need} bytes, more than the device holds"}

    state = jax.tree.map(lambda a: a.copy(), p)
    state = compiled(state)  # warm-up frame
    float(state.pos.ravel()[0])  # real fetch — surfaces device faults
    t0 = time.perf_counter()
    for _ in range(frames):
        state = compiled(state)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    float(state.pos.ravel()[0])

    # a NaN or a tile overflow mid-run must fail the candidate loudly
    if not (bool(jnp.isfinite(state.pos).all()) and bool(jnp.isfinite(state.vel).all())):
        raise RuntimeError("non-finite state — timing invalid")
    if spec is not None:
        over = _tiled_overflow(state, dom, spec, batch)
        if over:
            raise RuntimeError(
                f"tile overflow after timed run: {over} particles — capacity "
                f"spec invalid for this scene"
            )
    total = n * (batch or 1) * cfg.iterations * frames
    return {
        "value": round(total / dt),
        "s_per_frame": round(dt / frames, 6),
        "compile_s": round(compile_s, 3),
        "program_bytes": int(need),
    }


def max_abs_err(a, b):
    """(max|dpos|, max|dvel|) between two particle states."""
    import jax.numpy as jnp

    return (
        float(jnp.abs(a.pos - b.pos).max()),
        float(jnp.abs(a.vel - b.vel).max()),
    )


def verify_on_device(dim=3, n=20_000, substeps=VERIFY_SUBSTEPS, tol=VERIFY_TOL):
    """Run sorted and tiled against dense for ``substeps`` substeps on the
    current device; return {backend: (max|dpos|, max|dvel|)}.  Raises if
    either exceeds ``tol``.  The scatters sum in another order on every
    backend (atomics on a GPU), so agreement is to float32 reordering, not
    bitwise."""
    import jax

    from fluid_tpu import step
    from fluid_tpu.ops import tiled_transfer as tt

    cfg, p, dom = _make_scene(dim, n)
    mp, ma = step.no_mouse()
    spec = _tiled_spec(cfg, dom, n)
    subs = {
        "dense": lambda q: step.substep(q, cfg, dom, mp, ma, backend="dense")[0],
        "sorted": lambda q: step.substep(q, cfg, dom, mp, ma, backend="sorted")[0],
        "tiled": lambda q: tt.substep(q, cfg, dom, mp, ma, spec)[0],
    }

    def run(sub):
        return jax.block_until_ready(
            jax.jit(lambda q: jax.lax.fori_loop(0, substeps, lambda _, s: sub(s), q))(p)
        )

    ref = run(subs["dense"])
    errs = {}
    for name in ("sorted", "tiled"):
        errs[name] = max_abs_err(run(subs[name]), ref)
    bad = {k: v for k, v in errs.items() if not (v[0] <= tol and v[1] <= tol)}
    if bad:
        raise RuntimeError(
            f"{dim}D backend-vs-dense verification FAILED (tol {tol}): "
            + ", ".join(f"{k} max|dpos|={v[0]:.2e} max|dvel|={v[1]:.2e}" for k, v in bad.items())
        )
    return errs


def run_config(name, backends, quick, baselines):
    """Race ``backends`` on one config.  Returns (result dict, failures)."""
    dim, n, frames, batch, bkey = CONFIGS[name]
    if quick:
        n = min(n, 20_000)
        frames = max(2, frames // 4)
        batch = min(batch, 8) if batch else None
    cfg, p, dom = _make_scene(dim, n, batch)

    cands, failures = {}, []
    for b in backends:
        try:
            cands[b] = bench_backend(cfg, p, dom, frames, b, batch)
        except Exception as e:  # noqa: BLE001 — recorded, and fails the run
            cands[b] = {"failed": f"{type(e).__name__}: {e}"}
            failures.append(f"{name}/{b}")
        print(f"# {name}/{b}: {json.dumps(cands[b])}", file=sys.stderr)

    timed = {b: r for b, r in cands.items() if "value" in r}
    if not timed:
        raise RuntimeError(f"{name}: no backend produced a result: {cands}")
    best = max(timed, key=lambda b: timed[b]["value"])
    pps = timed[best]["value"]
    base = baselines.get(bkey, {}).get("particle_steps_per_sec")
    return {
        "config": name,
        "backend": best,
        "particles": n * (batch or 1),
        "value": pps,
        "unit": "particle-steps/s",
        "s_per_frame": timed[best]["s_per_frame"],
        "vs_baseline": round(pps / base, 2) if base else 0.0,
        "candidates": cands,
    }, failures


def device_info():
    """What the numbers were measured on: JAX's view of the devices, the
    card's name and power limit, and the XLA flags in force."""
    import jax

    from fluid_tpu.utils.platform import nvidia_smi

    d = jax.devices()
    return {
        "platform": d[0].platform,
        "kind": d[0].device_kind,
        "count": len(d),
        "nvidia_smi": nvidia_smi() if d[0].platform == "gpu" else "not a GPU",
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="3d-1m", choices=[*CONFIGS, "all"])
    ap.add_argument("--backend", default="auto", choices=("auto", *BACKENDS),
                    help="auto = race all backends")
    ap.add_argument("--platform", default=None, choices=(None, "cpu", "gpu"),
                    help="default: the GPU, and fail if there is none")
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU smoke)")
    args = ap.parse_args(argv)

    from fluid_tpu.utils import platform

    if args.platform == "cpu":
        platform.force_cpu()
    else:
        platform.require_gpu("pass --platform cpu to run on the CPU")
    platform.setup_compile_cache()

    info = device_info()
    print(f"# device: {json.dumps(info)}", file=sys.stderr)

    verify = {}
    for dim in (2, 3):
        errs = verify_on_device(dim=dim, n=4_000 if args.quick else 20_000)
        verify[f"{dim}d"] = {k: {"pos": v[0], "vel": v[1]} for k, v in errs.items()}
        print(f"# verify {dim}D vs dense: {json.dumps(verify[f'{dim}d'])}", file=sys.stderr)

    baselines = _load_baseline()
    backends = BACKENDS if args.backend == "auto" else (args.backend,)
    names = list(CONFIGS) if args.config == "all" else [args.config]
    results, failures = [], []
    for name in names:
        r, f = run_config(name, backends, args.quick, baselines)
        results.append(r)
        failures += f

    for r in results[:-1]:
        print(json.dumps(r))
    head = results[-1]
    print(json.dumps({
        "metric": f"particle-steps/sec ({head['config']}, backend={head['backend']}, "
        f"{info['platform']})",
        "value": head["value"],
        "unit": head["unit"],
        "vs_baseline": head["vs_baseline"],
        "s_per_frame": head["s_per_frame"],
        "candidates": head["candidates"],
        "verify_max_abs_err": verify,
        "device": info,
    }))
    if failures:
        print(f"# FAILED candidates: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
