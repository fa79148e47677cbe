"""chip_smoke.py off the card: it refuses to run without a GPU, its phases
run at tiny sizes with the CPU standing in for the card, its comparisons
catch wrong fields, and its last line has the contract's shape. The one
@pytest.mark.gpu test runs a phase on a real card (skipped here)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run_script(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_outside_the_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_script(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _cpu():
    return jax.devices("cpu")[0]


@pytest.mark.parametrize("name", [
    "main_path", "compare", "largest", "cascade_lod", "pond", "ensemble",
    "velocity", "invert_grad", "serve", "sharded"])
def test_phase_runs_at_tiny_size_on_cpu(name):
    """Every phase function at a tiny N, CPU device on both sides (the
    comparisons then hold exactly or to f32 rounding)."""
    cpu = _cpu()
    calls = {
        "main_path": lambda: cs.phase_main_path(cpu, n=32, steps=2),
        "compare": lambda: cs.phase_compare(cpu, cpu, n=32, steps=2),
        "largest": lambda: cs.phase_largest(cpu, cpu, n=64, steps=2),
        "cascade_lod": lambda: cs.phase_cascade(cpu, cpu, n=32),
        "pond": lambda: cs.phase_pond(cpu, cpu, n=32, waves=4),
        "ensemble": lambda: cs.phase_ensemble(cpu, cpu, n=32, members=2),
        "velocity": lambda: cs.phase_velocity(cpu, cpu, n=32),
        "invert_grad": lambda: cs.phase_invert_grad(cpu, cpu, n=16),
        "serve": lambda: cs.phase_serve(cpu, n=32, frames=3),
        "sharded": lambda: cs.phase_sharded(jax.devices()[:4], n=64,
                                            steps=2),
    }
    out = calls[name]()
    assert out is not None
    json.dumps(out, default=str)        # every result line is JSON


def _fields(n=32, seed=0):
    from tpu_ocean.solver import OceanSolver, PRODUCTION
    s = OceanSolver(cs.ocean_cfg(n), **PRODUCTION)
    _, f = s.step(s.init(jax.random.PRNGKey(seed)), 1 / 60)
    return cs._host(f)


def test_compare_fields_catches_wrong_fields():
    """A perturbed height and a broken column of normals (one halo column
    gone wrong) both fail the comparison; the untouched fields pass."""
    n = 32
    f = _fields(n)
    assert cs.compare_ocean(f, f, n)["height"] == 0.0
    h = f.height.copy()
    h[3, 4] += 1e-3 * np.abs(h).max()
    with pytest.raises(AssertionError, match="height"):
        cs.compare_ocean(f._replace(height=h), f, n)
    nrm = f.normal.copy()
    nrm[:, 5] = nrm[:, 6]
    with pytest.raises(AssertionError, match="normal"):
        cs.compare_ocean(f._replace(normal=nrm), f, n)


def _fake_main(monkeypatch, fail: bool):
    """main() with the CPU standing in for the GPU and trivial phases."""
    from tpu_ocean import benchlib
    monkeypatch.setattr(cs, "gpu_devices", lambda count: [_cpu()] * count)
    monkeypatch.setattr(benchlib, "card_info", lambda: "TEST CARD, 1.00 W")
    monkeypatch.setattr(benchlib, "enable_compile_cache", lambda: None)

    def ok(*a, **k):
        return {"fine": True}

    def bad(*a, **k):
        raise AssertionError("deliberate")
    for name in ("phase_main_path", "phase_compare", "phase_oracle",
                 "phase_largest", "phase_cascade", "phase_pond",
                 "phase_ensemble", "phase_velocity", "phase_invert_grad",
                 "phase_serve", "phase_sharded"):
        monkeypatch.setattr(cs, name, ok)
    if fail:
        monkeypatch.setattr(cs, "phase_pond", bad)


@pytest.mark.parametrize("chips", [1, 4])
def test_last_line_is_the_result_object(monkeypatch, capsys, chips):
    _fake_main(monkeypatch, fail=False)
    argv = [] if chips == 1 else ["--chips", "4"]
    assert cs.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(l.startswith("# nvidia-smi: TEST CARD") for l in lines[:-1])
    last = json.loads(lines[-1])
    assert set(last) == {"ok", "device"} and last["ok"] is True
    assert set(last["device"]) == {"platform", "kind", "count"}
    assert last["device"]["count"] == len(jax.devices())
    ran = [l for l in lines if l.startswith("[")]
    assert len(ran) == (1 if chips == 4 else 10)


def test_failed_phase_exits_nonzero_without_result(monkeypatch, capsys):
    """A failing phase is reported with its traceback, the other phases
    still run, and no result line is printed."""
    _fake_main(monkeypatch, fail=True)
    assert cs.main([]) == 1
    out = capsys.readouterr()
    assert "[pond] FAILED" in out.out and "deliberate" in out.err
    assert '"ok"' not in out.out
    assert "[serve] ok" in out.out


@pytest.mark.gpu
def test_compare_phase_on_gpu(gpu_device):
    """On a card: the shipping step vs the CPU at 256² (tolerances of the
    module docstring)."""
    out = cs.phase_compare(gpu_device, _cpu(), n=256, steps=2)
    assert out["shipping_vs_cpu_full"]["height"] <= cs.FIELD_TOL
