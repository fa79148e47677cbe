"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: heightfield grid-points per second on one card at 1024², full
ocean step (spectrum assembly → batched 2-D IFFT → normals → whitecap foam)
on the flagship OCEAN_DEMO configuration with the shipping switches
(solver.PRODUCTION on the jnp.fft backend).

vs_baseline: the reference is an interactive Unity demo at 1024² textures
with an implied real-time (60 FPS) target (SURVEY.md §6; no published numbers
exist), i.e. 1024² × 60 ≈ 6.29e7 grid-points/s. vs_baseline = measured / that.

Timing: benchlib.time_steps_ladder — K steps inside one executable, walls
ending in block_until_ready at several K, slope fitted, validity-checked
(a suspect fit publishes no number). Everything runs in this one process.
The line names the card (JAX's device_kind and count, nvidia-smi's name and
power limit) and carries each variant's share of the card's published HBM
bandwidth (benchlib.PEAKS, keyed by device_kind — an unknown card is an
error). With no GPU the script exits non-zero and prints no metric.

Usage: python bench.py [--res N] [--steps K] [--backend auto|all|NAME]
                       [--pack-channels] [--half-spectrum]
                       [--precision float32|bfloat16]

  auto  the shipping step (the headline);
  all   the shipping step, then every backend with pack_channels, in turn;
  NAME  one backend (reference|stockham|matmul) with the given switches.
"""

from __future__ import annotations

import argparse
import json
import sys


def _variant_label(backend: str, packed: bool, half: bool, real: bool,
                   precision: str = "float32") -> str:
    """Label carrying EVERY switch that changes what the number means."""
    return (backend + ("+real" if real else "") + ("+packed" if packed else "")
            + ("+half" if half else "")
            + ("+bf16" if precision == "bfloat16" else ""))


def step_bytes(n: int, packed: bool, half: bool) -> float:
    """Least device-memory traffic of one stencil-normals step, in bytes:
    f32 [N, N] planes counted per stage (4 h0 + 2 phase read/write, per
    transformed channel: assembly write 2, one read+write per FFT axis pass
    8, plus 3 stencil reads and 7 non-transform output planes). The half
    channel moves about half its transform planes."""
    pch = 2 if packed else 3
    planes = 16 + 10 * pch - (5 if half else 0)
    return planes * n * n * 4.0


def measure(backend: str, res: int, steps: int, precision: str,
            **switches) -> dict:
    import jax
    from tpu_ocean.config import OCEAN_DEMO
    from tpu_ocean.solver import OceanSolver
    from tpu_ocean.benchlib import time_steps_ladder

    cfg = OCEAN_DEMO.replace(resolution=res, length=float(res),
                             precision=precision)
    solver = OceanSolver(cfg, fft_backend=backend, **switches)
    state = solver.init(jax.random.PRNGKey(0))
    k = max(4, steps // 4)
    lad = time_steps_ladder(solver._step_impl, state, 1.0 / 60.0,
                            ks=(k, 4 * k, 16 * k), extra=solver._consts)
    return {"backend": _variant_label(
                backend, switches.get("pack_channels", False),
                switches.get("half_spectrum", False),
                switches.get("real_state", False), precision),
            "per_step_s": lad.per_step_s, "suspect": bool(lad.suspect),
            "ladder_ks": lad.ks, "ladder_walls_s": lad.walls_s,
            "fit_max_rel_resid": lad.max_rel_resid,
            "intercept_ms": lad.intercept_s * 1e3,
            "packed": switches.get("pack_channels", False),
            "half": switches.get("half_spectrum", False)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--backend", type=str, default="auto",
                    help="'auto' (shipping step), 'all', or one backend")
    ap.add_argument("--pack-channels", action="store_true",
                    help="Hermitian channel packing, 2 FFTs for 3 fields "
                         "(parity-ledger switch — docs/parity.md)")
    ap.add_argument("--half-spectrum", action="store_true",
                    help="C2R route for the last packed channel (needs "
                         "--pack-channels)")
    ap.add_argument("--precision", type=str, default="float32",
                    choices=["float32", "bfloat16"],
                    help="dot precision of the matmul backend (bfloat16 = "
                         "fast mode, ~4e-3 rel err — docs/parity.md)")
    args = ap.parse_args(argv)

    import jax
    from tpu_ocean.benchlib import card_info, enable_compile_cache, peaks_for
    from tpu_ocean.solver import PRODUCTION

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX's first device is {dev.platform}); "
              f"device metrics come from a GPU run only", file=sys.stderr)
        return 2
    peaks = peaks_for(dev)
    enable_compile_cache()
    card = card_info()

    ship = dict(PRODUCTION)
    if args.backend == "auto":
        runs = [("reference", ship)]
    elif args.backend == "all":
        runs = [("reference", ship)] + [
            (b, {"pack_channels": True})
            for b in ("reference", "matmul", "stockham")]
    else:
        runs = [(args.backend, {"pack_channels": args.pack_channels,
                                "half_spectrum": args.half_spectrum})]
    collected = []
    for backend, sw in runs:
        r = measure(backend, args.res, args.steps, args.precision, **sw)
        print(f"# {r['backend']}: {r['per_step_s'] * 1e3:.4f} ms/step "
              f"({'SUSPECT' if r['suspect'] else 'valid'}; {card})",
              file=sys.stderr)
        collected.append(r)

    n = args.res

    def roofline(r):
        b = step_bytes(n, r["packed"], r["half"])
        return {"model_mb_per_step": b / 1e6,
                "hbm_roofline_frac": b / r["per_step_s"]
                / peaks["hbm_bytes_per_s"]}

    head = collected[0]
    step_s = head["per_step_s"]
    ok = not head["suspect"]
    gps = n * n / step_s
    out = {
        "metric": f"heightfield grid-points/s/card at {n}^2",
        "value": gps if ok else None,
        "unit": "gp/s",
        "vs_baseline": gps / (1024 * 1024 * 60.0) if ok else None,
        "backend": head["backend"],
        "ms_per_step": step_s * 1e3 if ok else None,
        "updates_per_s": 1.0 / step_s if ok else None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "peaks_source": peaks["source"],
    }
    for key in ("ladder_ks", "ladder_walls_s", "fit_max_rel_resid",
                "intercept_ms"):
        out[key] = head[key]
    if ok:
        out.update(roofline(head))
    else:
        out["timing_suspect"] = True   # validity self-check failed
        out["rejected_ms_per_step"] = step_s * 1e3
    if len(collected) > 1:
        out["variants"] = [dict({"backend": r["backend"],
                                 "ms_per_step": r["per_step_s"] * 1e3,
                                 "suspect": r["suspect"]}, **roofline(r))
                           for r in collected]
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
