"""bench.py — one process, one JSON line, device named, no CPU fallback.

The measurement itself needs a GPU; here the CPU-only refusal, the variant
labels, the byte model, the timing function on CPU, and main()'s assembly
of the result line (with the GPU and the card query faked) are checked.
"""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest

_BENCH = os.path.join(os.path.dirname(__file__), os.pardir, "bench.py")


def _load_bench():
    spec = importlib.util.spec_from_file_location("bench_under_test", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_variant_label_carries_precision():
    mod = _load_bench()
    assert mod._variant_label("reference", True, True, True) == \
        "reference+real+packed+half"
    assert mod._variant_label("matmul", True, False, False, "bfloat16") == \
        "matmul+packed+bf16"


def test_step_bytes_model_orders_variants():
    """Packing moves fewer planes than the 3-channel step, the C2R half
    route fewer still; bytes scale with N²."""
    mod = _load_bench()
    full = mod.step_bytes(1024, packed=False, half=False)
    packed = mod.step_bytes(1024, packed=True, half=False)
    half = mod.step_bytes(1024, packed=True, half=True)
    assert full > packed > half > 0
    assert mod.step_bytes(2048, True, True) == 4 * half


def test_cpu_only_exits_nonzero_without_metric(capsys):
    """No GPU: exit code 2, no JSON line, nothing under a device metric."""
    mod = _load_bench()
    rc = mod.main(["--res", "32", "--steps", "8"])
    out = capsys.readouterr()
    assert rc == 2
    assert not [l for l in out.out.splitlines() if l.startswith("{")]
    assert "no GPU" in out.err


def test_measure_times_the_step_in_process():
    """The timing path (benchlib ladder, block_until_ready walls) on the
    CPU device — what main() runs per variant on the card."""
    mod = _load_bench()
    r = mod.measure("reference", 32, 8, "float32", real_state=True,
                    pack_channels=True, half_spectrum=True)
    assert r["backend"] == "reference+real+packed+half"
    assert r["per_step_s"] > 0 and len(r["ladder_walls_s"]) == 3


@pytest.mark.parametrize("backend,n_variants", [("auto", 1), ("all", 4)])
def test_main_result_line_names_the_card(monkeypatch, capsys, backend,
                                         n_variants):
    """main() on a (faked) H100: one JSON line naming device_kind, count,
    nvidia-smi's name and power limit, with the HBM roofline share from
    benchlib.PEAKS; 'all' adds one variant per backend."""
    import jax
    from tpu_ocean import benchlib
    mod = _load_bench()
    fake = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jax, "devices", lambda *a: [fake])
    monkeypatch.setattr(benchlib, "card_info",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(benchlib, "enable_compile_cache", lambda: None)
    calls = []

    def fake_measure(b, res, steps, precision, **sw):
        calls.append((b, sw))
        return {"backend": mod._variant_label(
                    b, sw.get("pack_channels", False),
                    sw.get("half_spectrum", False),
                    sw.get("real_state", False), precision),
                "per_step_s": 2e-4, "suspect": False, "ladder_ks": [1, 4, 16],
                "ladder_walls_s": [0.1, 0.2, 0.5], "fit_max_rel_resid": 0.01,
                "intercept_ms": 1.0, "packed": sw.get("pack_channels", False),
                "half": sw.get("half_spectrum", False)}
    monkeypatch.setattr(mod, "measure", fake_measure)
    rc = mod.main(["--backend", backend])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert out["device"] == {"platform": "gpu",
                             "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    assert out["card"].endswith("700.00 W")
    assert out["backend"] == "reference+real+packed+half"
    assert out["ms_per_step"] == pytest.approx(0.2)
    assert 0 < out["hbm_roofline_frac"] < 1
    assert len(calls) == n_variants
    assert len(out.get("variants", [out])) == n_variants
