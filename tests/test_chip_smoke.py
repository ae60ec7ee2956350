"""chip_smoke.py's checks, run on the CPU at tiny sizes: the tolerance and
state checks must catch what they claim to, and the parity phases must
pass on a correct build."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from fluid_tpu import scene  # noqa: E402


@pytest.mark.parametrize(
    "err,ok", [(0.0, True), (1e-3, True), (1.1e-3, False), (float("nan"), False)],
    ids=["zero", "at-tol", "over-tol", "nan"],
)
def test_check_against_tolerance(err, ok, capsys):
    if ok:
        chip_smoke.check("x", err, 1e-3)
        assert "ok" in capsys.readouterr().out
    else:
        with pytest.raises(RuntimeError, match="exceeds tolerance"):
            chip_smoke.check("x", err, 1e-3)
        assert "FAIL" in capsys.readouterr().out


def _bad(p, kind):
    if kind == "nan":
        return dataclasses.replace(p, pos=p.pos.at[3, 0].set(jnp.nan))
    if kind == "outside":
        return dataclasses.replace(p, pos=p.pos.at[3, 1].set(-1.0))
    if kind == "mass":
        return dataclasses.replace(p, mass=p.mass.at[3].set(0.0))
    return p


@pytest.mark.parametrize("kind", ["good", "nan", "outside", "mass"])
def test_check_state(kind):
    cfg, p, _ = scene.reference_scene_2d(n=64)
    p = _bad(p, kind)
    if kind == "good":
        chip_smoke.check_state("s", p, cfg, 64)
    else:
        with pytest.raises(RuntimeError, match="s: "):
            chip_smoke.check_state("s", p, cfg, 64)


@pytest.mark.parametrize("dim", [2, 3])
def test_oracle_parity_phase(dim):
    chip_smoke.oracle_parity(dim, substeps=2, n=48)


def test_backend_parity_phase():
    errs = bench.verify_on_device(dim=3, n=2000)
    assert set(errs) == {"sorted", "tiled"}
    assert all(max(e) <= bench.VERIFY_TOL for e in errs.values())


def test_four_cards_phase_on_virtual_devices(capsys):
    if len(jax.devices()) < 4:
        pytest.fail("conftest provides 8 virtual CPU devices")
    chip_smoke.phase_four_cards("cpu", n=2048)
    out = capsys.readouterr().out
    assert out.count("four-cards slab") == 4
    assert "migration lossless" in out
