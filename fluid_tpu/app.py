"""Interactive terminal app — parity with the reference's ``main`` loop
(``2d_multi.rs:491-544`` / ``3d_multi.rs:514-568``) plus a headless mode.

Layer map parity (SURVEY.md §1 L4/L5):
  * raw-mode alternate-screen terminal with hidden cursor and mouse capture
    (``setup_terminal``/``restore_terminal``, ``2d_multi.rs:393-411``) —
    implemented with termios + ANSI escapes instead of crossterm;
  * a blocking stdin reader thread feeding Quit/Drag events through a
    bounded(1) queue with drop-when-full semantics (``event_handler`` +
    crossbeam channel, ``2d_multi.rs:413-436,495``);
  * per frame: poll input -> map console coords to world (``2d_multi.rs:
    525-527``) -> draw -> step -> sleep(dt) (``2d_multi.rs:518-539``).

Improvements over the reference (documented deviations):
  * terminal state is restored in a ``finally`` block (the reference leaks raw
    mode on panic — SURVEY.md §5.3);
  * ``--headless --frames N`` runs without a TTY for CI/smoke tests;
  * per-phase timing overlay (``--timing``) reports device-side phase times
    via separately-jitted phases; the default fused frame shows one
    whole-frame time (the fused XLA program has no host-visible phase
    boundaries — fusing them is the point).

Usage::

    python -m fluid_tpu.app --dim 2            # interactive, q to quit
    python -m fluid_tpu.app --dim 3 --headless --frames 10
    python -m fluid_tpu.app --dim 2 --cpu      # on the CPU (default: GPU)
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from . import render as render_mod
from . import scene, step
from .config import default_2d, default_3d
from .parallel import shard
from .utils.timing import PhaseTimer


@dataclass
class Quit:
    pass


@dataclass
class Drag:
    col: int
    row: int


def _event_reader(q: "queue.Queue", stop: threading.Event) -> None:
    """Blocking stdin reader thread (``event_handler``, 2d_multi.rs:413-436).

    Parses 'q' for Quit and SGR mouse reports (``\\x1b[<b;x;yM``) for
    press/drag events.  Drag events use put_nowait (drop-when-full), Quit
    blocks — matching the reference's try_send/send split
    (``2d_multi.rs:419-431``).
    """
    buf = b""
    while not stop.is_set():
        ch = sys.stdin.buffer.read(1)
        if not ch:
            return
        buf += ch
        if buf.endswith(b"q") and not buf.startswith(b"\x1b"):
            q.put(Quit())
            return
        if buf.startswith(b"\x1b"):
            # SGR mouse: ESC [ < b ; x ; y (M|m)
            if buf[-1:] in (b"M", b"m") and b"<" in buf:
                try:
                    body = buf[buf.index(b"<") + 1 : -1].decode()
                    b_code, x, y = (int(v) for v in body.split(";"))
                    is_press_or_drag = buf.endswith(b"M") and (b_code & 3) != 3
                    if is_press_or_drag:
                        try:
                            q.put_nowait(Drag(x - 1, y - 1))
                        except queue.Full:
                            pass
                except ValueError:
                    pass
                buf = b""
            elif len(buf) > 32:
                buf = b""
        else:
            buf = b""


def _setup_terminal() -> "list":
    """Raw mode + alt screen + hide cursor + SGR mouse capture
    (``setup_terminal``, 2d_multi.rs:393-401)."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setraw(fd)
    sys.stdout.write("\x1b[?1049h\x1b[?25l\x1b[?1002h\x1b[?1006h")
    sys.stdout.flush()
    return old


def _restore_terminal(old) -> None:
    """(``restore_terminal``, 2d_multi.rs:403-411)."""
    import termios

    sys.stdout.write("\x1b[?1006l\x1b[?1002l\x1b[?25h\x1b[?1049l")
    sys.stdout.flush()
    termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, old)


class _ShardedLoop:
    """The app's frame/render interface over ``parallel.shard``: x-slabs of
    the dense grid on a 1-D mesh of the first ``shards`` devices."""

    def __init__(self, cfg, dom, p, shards: int):
        devs = jax.devices()
        if len(devs) < shards:
            raise SystemExit(
                f"--shards {shards} needs {shards} devices, have {len(devs)} "
                f"(with --cpu they are virtual CPU devices)"
            )
        self.cfg = cfg
        self.n = p.n
        self.mesh = Mesh(np.array(devs[:shards]), (shard.AXIS,))
        self.spec = shard.default_spec(dom, shards, p.n)
        self.lp = shard.shard_particles(p, self.spec, self.mesh)

    def frame(self, mouse) -> None:
        self.lp = shard.sharded_frame(
            self.lp, self.cfg, self.spec, self.mesh, *mouse
        )

    def block_until_ready(self) -> None:
        jax.block_until_ready(self.lp)

    def particles(self):
        # gathering checks conservation (each uid alive exactly once)
        return shard.gather_particles(self.lp, self.n)

    def render(self, viewport, console) -> list:
        return render_mod.render(self.particles(), viewport, console)


def run(
    dim: int = 2,
    n: int = scene.REFERENCE_N,
    seed: int = 0,
    frames: Optional[int] = None,
    headless: bool = False,
    backend: str = "auto",
    timing: bool = False,
    shards: Optional[int] = None,
    out=None,
):
    """Run the frame loop; returns the final particle state."""
    out = out or sys.stdout
    cfg = default_2d() if dim == 2 else default_3d()
    p, dom = scene.dam_break(jax.random.key(seed), cfg, n=n)

    from . import session as session_mod

    if backend == "auto":
        backend = session_mod.default_backend()

    viewport = render_mod.DEFAULT_VIEWPORT
    console = render_mod.DEFAULT_CONSOLE
    timer = None
    loop = None  # Session or _ShardedLoop: frame/render/particles
    if shards:
        # multi-device interactive surface: dense x-slabs over a 1-D mesh
        # behind the same frame/render loop.  The timing overlay is
        # single-device only (probing one shard would lie).
        loop = _ShardedLoop(cfg, dom, p, shards)
    elif timing:
        # the overlay always times the REQUESTED backend: dense gets the
        # reference's per-phase split (2d_multi.rs:479-487), other fused
        # backends get honest per-substep timing of their own code path
        timer = PhaseTimer(cfg, dom, backend=backend)
    else:
        loop = session_mod.Session(cfg, dom, p, backend=backend)

    ev_q: "queue.Queue" = queue.Queue(maxsize=1)
    stop = threading.Event()
    old_term = None
    if not headless:
        old_term = _setup_terminal()
        t = threading.Thread(target=_event_reader, args=(ev_q, stop), daemon=True)
        t.start()

    frame_i = 0
    try:
        while frames is None or frame_i < frames:
            mouse: Tuple[jnp.ndarray, jnp.ndarray] = step.no_mouse()
            try:
                ev = ev_q.get_nowait()
                if isinstance(ev, Quit):
                    break
                if isinstance(ev, Drag):
                    # console -> world (2d_multi.rs:525-527)
                    wx = ev.col / console[0] * viewport[0]
                    wy = ev.row / console[1] * viewport[1]
                    mouse = step.mouse((wx, wy))
            except queue.Empty:
                pass

            t0 = time.perf_counter()
            if timer is not None:
                lines = render_mod.render(p, viewport, console)
                p, phase_times = timer.frame(p, *mouse)
            else:
                lines = loop.render(viewport, console)
                loop.frame(mouse)
                loop.block_until_ready()
                phase_times = [("frame", time.perf_counter() - t0)]

            if headless:
                out.write(f"--- frame {frame_i} ---\n")
                out.write("\n".join(lines) + "\n")
                for label, secs in phase_times:
                    out.write(f"{label}: {secs * 1e3:.3f}ms\n")
            else:
                buf = []
                for y, line in enumerate(lines):
                    buf.append(f"\x1b[{y + 1};1H{line}")
                for i, (label, secs) in enumerate(phase_times):
                    buf.append(
                        f"\x1b[{console[1] + 1 + i};1H{label}: {secs * 1e3:.3f}ms\x1b[0K"
                    )
                buf.append("\x1b[0J")
                out.write("".join(buf))
                out.flush()

            frame_i += 1
            if not headless:
                time.sleep(cfg.dt)  # 2d_multi.rs:538
    finally:
        stop.set()
        if old_term is not None:
            _restore_terminal(old_term)
    return p if timer is not None else loop.particles()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="fluid-tpu interactive dam-break")
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--particles", type=int, default=scene.REFERENCE_N)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=None, help="stop after N frames")
    ap.add_argument("--headless", action="store_true", help="no TTY; print frames")
    ap.add_argument(
        "--backend", default="auto",
        choices=("auto", "dense", "sorted", "tiled"),
        help="transfer backend; auto = session.default_backend()",
    )
    ap.add_argument("--timing", action="store_true", help="per-phase timing overlay")
    ap.add_argument(
        "--cpu", action="store_true",
        help="run on the CPU (without it, a GPU is required)",
    )
    ap.add_argument(
        "--shards", type=int, default=None,
        help="split the domain into x-slabs over an N-device mesh "
        "(with --cpu: N virtual CPU devices)",
    )
    args = ap.parse_args(argv)
    if args.timing and args.shards:
        raise SystemExit("--timing is single-device only (drop --shards)")
    from .utils import platform

    if args.cpu:
        platform.force_cpu(args.shards or 1)
    else:
        platform.require_gpu("pass --cpu to run on the CPU")
    platform.setup_compile_cache()
    run(
        dim=args.dim,
        n=args.particles,
        seed=args.seed,
        frames=args.frames,
        headless=args.headless,
        backend=args.backend,
        timing=args.timing,
        shards=args.shards,
    )


if __name__ == "__main__":
    main()
