"""Baseline configuration harness — emits one JSON line per config.

    python bench/run_baselines.py [--configs 1,2,3,4,5] [--backend reference]

Configs:
  1. 64² heightfield, single step — vs the float64 oracle.
  2. 256² full state × 100 steps — vs the oracle at the final time, on the
     FFT route AND the eval_mode="direct" einsum route (the dense-matmul
     path where reduced-precision f32 dots would show).
  3. 512² Gerstner pond, 16 waves (+ the sinusoid sheet) — throughput.
  4. 1024² single-device ocean step — updates/s.
  5. 4096² single-device ocean step — updates/s (skipped on CPU).

Parity configs run on whatever device JAX picks (the comparison happens on
the host against the numpy oracle). Throughput configs time on that device
and name it in every line.
"""

from __future__ import annotations


# repo-root import bootstrap: these scripts run directly from a checkout
# (sys.path[0] is the script's own dir, not the repo root)
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import sys

import numpy as np

#: oracle tolerances (rtol, atol as a fraction of max|field|), as in
#: tests/test_parity.py: one step is held to f32 rounding; 100 steps of
#: absolute-time evolution accumulate f32 phase error, so config 2 gets the
#: looser pair
TOL = {1: (1e-4, 2e-5), 2: (1e-3, 2e-4)}


def _emit(obj):
    print(json.dumps(obj))
    sys.stdout.flush()
    return obj


def _device() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _parity_case(n, steps, tol, eval_mode="fft", seed=0):
    """Solver vs float64 oracle on a shared h0; returns {field: max|Δ|/max}
    and whether every field met the oracle tolerance."""
    import jax
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.oracle import Oracle, assert_fields_close
    from tpu_ocean.solver import OceanSolver

    cfg = OceanConfig(resolution=n, length=float(n), unit_width=1.0,
                      wind=(8.0, 5.0), amplitude=0.05, choppiness=1.2,
                      dispersion_mode="quantized", evolution_mode="absolute",
                      spectrum_layout="centered", normals_mode="spectral",
                      seed=seed)
    oracle = Oracle(cfg, rng=np.random.default_rng(seed))
    solver = OceanSolver(cfg, eval_mode=eval_mode)
    state = solver.init(h0=oracle.h0.astype(np.complex64),
                        h0_conj=oracle.h0_conj.astype(np.complex64))
    dt = 1.0 / 60.0
    for _ in range(steps):
        state, fields = solver.step(state, dt)
    jax.block_until_ready(fields.height)
    want = oracle.fields(steps * dt / cfg.t_division)
    try:
        errs = assert_fields_close(fields, want, rtol=tol[0],
                                   atol_scale=tol[1])
        return errs, True
    except AssertionError as e:
        return {"error": str(e)[:300]}, False


def config1():
    errs, ok = _parity_case(64, steps=1, tol=TOL[1])
    return _emit({"config": 1, "desc": "64^2 single step vs oracle",
                  "device": _device(), "max_rel_err": errs, "pass": ok})


def config2():
    out = []
    for mode in ("fft", "direct"):
        errs, ok = _parity_case(256, steps=100, tol=TOL[2], eval_mode=mode)
        out.append(_emit({"config": 2,
                          "desc": f"256^2 x100 steps vs oracle ({mode})",
                          "device": _device(), "max_rel_err": errs,
                          "pass": ok}))
    return out


def _ladder(step_impl, state, extra=None, ks=(16, 128, 1024)):
    from tpu_ocean.benchlib import time_steps_ladder
    return time_steps_ladder(step_impl, state, 1.0 / 60.0, ks=ks,
                             extra=extra)


def config3():
    import jax.numpy as jnp
    from tpu_ocean.gerstner import WaveBank, gerstner_eval, sinusoid_eval
    from tpu_ocean.config import PondConfig
    from tpu_ocean import grids

    n, w = 512, 16
    bank = WaveBank.random(0, w)
    x, z = grids.coordinate_grid(n, 1.0)
    x = jnp.asarray(np.asarray(x, np.float32))
    z = jnp.asarray(np.asarray(z, np.float32))
    pcfg = PondConfig(amplitude=0.6, frequency=1.3, speed=1.1)
    out = []
    for desc, raw in (
            (f"512^2 Gerstner {w} waves",
             lambda t: gerstner_eval(bank, x, z, t, "analytic")),
            ("512^2 sinusoid pond", lambda t: sinusoid_eval(pcfg, x, z, t))):
        lad = _ladder(lambda t, dt, f=raw: (t + dt, f(t)),
                      jnp.zeros((), jnp.float32))
        s = lad.per_step_s
        out.append(_emit({"config": 3, "desc": desc, "device": _device(),
                          "ms_per_eval": s * 1e3,
                          "updates_per_s": 1 / s,
                          "timing_suspect": lad.suspect,
                          "pass": not lad.suspect and 1 / s > 60}))
    return out


def _ocean_throughput(n, backend, steps=64):
    """(per_step_s, suspect) of the requested backend via the K-ladder."""
    import jax
    from tpu_ocean.config import OCEAN_DEMO
    from tpu_ocean.solver import OceanSolver

    cfg = OCEAN_DEMO.replace(resolution=n, length=float(n))
    solver = OceanSolver(cfg, fft_backend=backend)
    state = solver.init(jax.random.PRNGKey(0))
    k = max(4, steps // 4)
    lad = _ladder(solver._step_impl, state, solver._consts,
                  ks=(k, 4 * k, 16 * k))
    return lad.per_step_s, bool(lad.suspect)


def _throughput_config(c, n, backend, steps):
    s, suspect = _ocean_throughput(n, backend, steps)
    return _emit({"config": c, "desc": f"{n}^2 ocean step ({backend})",
                  "device": _device(), "ms_per_step": s * 1e3,
                  "updates_per_s": 1 / s, "timing_suspect": suspect,
                  # a suspect ladder can never publish a pass verdict
                  "pass": False if suspect else 1 / s > 60})


def config5(backend):
    import jax
    if jax.default_backend() == "cpu":
        return _emit({"config": 5, "desc": "4096^2 (skipped on CPU)",
                      "pass": None})
    return _throughput_config(5, 4096, backend, steps=20)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=str, default="1,2,3,4,5")
    ap.add_argument("--backend", type=str, default="reference")
    args = ap.parse_args()

    fns = {1: config1, 2: config2, 3: config3,
           4: lambda: _throughput_config(4, 1024, args.backend, 64),
           5: lambda: config5(args.backend)}
    results = []
    for c in (int(x) for x in args.configs.split(",")):
        r = fns[c]()
        results.extend(r if isinstance(r, list) else [r])
    return 0 if all(r.get("pass") is not False for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
