#!/usr/bin/env python3
"""Smoke test of the ocean system on NVIDIA GPUs — the quickest proof that
the main path still starts, compiles and computes the right fields there.

    python3 chip_smoke.py              # one GPU: every single-card phase
    python3 chip_smoke.py --chips 4    # four GPUs: the sharded phase only

One process drives the card(s); the CPU side of every comparison runs in the
same process on ``jax.devices("cpu")[0]`` with the same seed. Each phase
prints one line ``[phase] ok <seconds>s <details>``, or ``[phase] FAILED``
and its traceback; every phase runs, and if any failed the script exits
non-zero without a result line. Single-card phases:

  main path   ``python -m tpu_ocean ocean --production --res 1024`` in
              process, then the same step compiled alone: compile seconds,
              ``memory_analysis()``, per-step milliseconds;
  compare     at 1024²: the shipping step vs the same config with
              half_spectrum=False on the CPU; the unpacked complex reference
              step vs the CPU; real_state vs complex state on the GPU;
  oracle      configs 1 and 2 of bench/run_baselines.py vs the float64
              oracle, the eval_mode="direct" einsum route included;
  8192²       the largest single-card shipping step: 3 steps, memory, finite
              fields, one step vs the CPU;
  families    one step each vs the CPU: the 3-band 512² production cascade
              and its LOD schedule, the 512² pond (16 waves), an 8-member
              ensemble at 512², velocity(), one gradient of
              examples/invert_sea_state.py's loss at n=64; then a FrameServer
              whose client thread receives 5 frames.

With ``--chips 4``: a 1×4 ('batch', 'shard') DistributedOceanSolver at 8192²
with the shipping switches (the mirror-balanced sharded C2R route), 3 steps,
compared with the single-card OceanSolver on device 0; the output must span
4 devices. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Tolerances, GPU vs CPU (both f32, all dots at HIGHEST): max|Δ| ≤ 1e-5 ·
max|field| for height and displacement; ≤ 1e-4 absolute plus the
propagated bound of that position tolerance for the unit normals (NORMAL_TOL
says why); foam under the
near-threshold rule of tpu_ocean.oracle.assert_fields_close; the pond's
trigonometric sums to 1e-4 · max (POND_TOL). The two sides run different
FFT libraries, so they agree to f32 rounding, not bitwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: GPU-vs-CPU field tolerance (fraction of max|field|) and normals (absolute)
FIELD_TOL = 1e-5
NORMAL_TOL = 1e-4
#: normals: a stencil normal is the normalized sum n of four cross products
#: of edge vectors between displaced neighbours, so position errors ≤ δ
#: reach it as |Δ(n/|n|)| ≤ 16·δ·L/|n| (L: the texel's four edge lengths;
#: each edge is off by ≤ 2δ and sits in two products; normalizing doubles
#: the relative error). Where the surface steepens or folds |n| → 0 and the
#: bound grows without limit (measured on an H100 against the CPU: 1e-3 at
#: 1024² and 2.5e-2 at 8192² on such texels). Each texel is held to
#: NORMAL_TOL plus that bound, with δ the largest position difference the
#: comparison measured (itself held to FIELD_TOL above)
#: foam's relative term, as in the oracle rule (tests/test_parity.py):
#: foam is a smoothstep of the Jacobian, itself a finite difference of the
#: displacements, so f32 rounding of the two FFT libraries reaches it
#: amplified near the threshold
FOAM_RTOL = 1e-4
#: pond tolerance (fraction of max|field|): the Gerstner phases k·x + ω·t
#: reach ~10³ rad over a 512² grid, where one f32 ulp of the argument is
#: ~6e-5 rad, and the two sides' sin/cos round differently there
POND_TOL = 1e-4
#: gradient tolerance (fraction of max|grad|): a gradient back through
#: several unrolled steps accumulates more rounding than one forward step
GRAD_TOL = 1e-4
SEED = 0


def _load(relpath: str, name: str):
    """Import a repo script (bench/ or examples/) by path."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gpu_devices(count: int):
    """The first ``count`` GPUs JAX sees; SystemExit when there are fewer
    (never a fallback to the CPU)."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: JAX finds no GPU ({e})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPU(s), JAX finds "
                         f"{len(devs)}")
    return devs[:count]


def phase(name: str, fn, *args, **kw):
    """Run one phase, print its result line, return what it returned."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    dt = time.perf_counter() - t0
    print(f"[{name}] ok {dt:.2f}s {json.dumps(out, default=str)}",
          flush=True)
    return out


def run_phases(phases) -> list:
    """Run every (name, fn, args) phase; a phase that raises is reported
    with its traceback and the rest still run. Returns the failed names."""
    import traceback
    failed = []
    for name, fn, args in phases:
        try:
            phase(name, fn, *args)
        except Exception:
            print(f"[{name}] FAILED", flush=True)
            traceback.print_exc()
            failed.append(name)
    return failed


def _host(tree):
    import jax
    return jax.tree.map(np.asarray, jax.device_get(tree))


def positions(f, chop: float) -> np.ndarray:
    """The normals stencil's displaced positions (chop·dx, h, chop·dz)."""
    return np.stack([chop * np.asarray(f.disp_x, np.float64),
                     np.asarray(f.height, np.float64),
                     chop * np.asarray(f.disp_z, np.float64)], axis=-1)


def normal_bound(want, chop: float, texel: float, delta: float) -> np.ndarray:
    """Per-texel normal tolerance 16·δ·L/|n| (see NORMAL_TOL) for position
    errors ≤ ``delta``, from the reference side's displaced positions (f64,
    fields.normals_stencil's edges); leading batch axes allowed."""
    p = positions(want, chop)
    ax0, ax1 = p.ndim - 3, p.ndim - 2

    def edge(axis, shift, offset):
        e = np.roll(p, -shift, axis) - p
        e[..., offset[0]] += offset[1]
        return e
    right = edge(ax0, 1, (0, texel))
    left = edge(ax0, -1, (0, -texel))
    top = edge(ax1, -1, (2, -texel))
    bottom = edge(ax1, 1, (2, texel))
    n = (np.cross(right, top) + np.cross(top, left)
         + np.cross(left, bottom) + np.cross(bottom, right))
    length = sum(np.linalg.norm(e, axis=-1)
                 for e in (right, left, top, bottom))
    return 16.0 * delta * length / np.maximum(np.linalg.norm(n, axis=-1),
                                              1e-30)


def compare_fields(got, want, chop: float, texel: float) -> dict:
    """GPU-vs-CPU field check (module docstring tolerances); ``chop`` and
    ``texel`` are the choppiness applied to disp_* by the normals stencil
    and the grid spacing. Returns the measured max|Δ|/max per field
    (jacobian reported, not gated) and raises AssertionError listing every
    field that missed."""
    errs, bad = {}, []
    for name in ("height", "disp_x", "disp_z", "foam", "jacobian"):
        g = np.asarray(getattr(got, name), np.float64)
        w = np.asarray(getattr(want, name), np.float64)
        peak = max(float(np.abs(w).max()), 1e-12)
        d = np.abs(g - w)
        errs[name] = float(d.max()) / peak
        if name in ("height", "disp_x", "disp_z") and errs[name] > FIELD_TOL:
            bad.append(name)
        if name == "foam":
            # near-threshold rule (tpu_ocean.oracle.assert_fields_close):
            # a 25x band, used by at most 0.1% of texels
            tight = FIELD_TOL * peak + FOAM_RTOL * np.abs(w)
            errs["foam_frac_over_tight"] = float(np.mean(d > tight))
            if (d > 25.0 * tight).any() or errs["foam_frac_over_tight"] >= 1e-3:
                bad.append(name)
    dn = np.abs(np.asarray(got.normal, np.float64)
                - np.asarray(want.normal)).max(axis=-1)
    delta = float(np.abs(positions(got, chop)
                         - positions(want, chop)).max())
    bound = NORMAL_TOL + normal_bound(want, chop, texel, delta)
    errs["normal_abs"] = float(dn.max())
    errs["normal_worst_share_of_bound"] = float((dn / bound).max())
    errs["normal_share_over_tol"] = float(np.mean(dn > NORMAL_TOL))
    if (dn > bound).any():
        bad.append("normal")
    assert not bad, f"fields {bad} out of tolerance: {errs}"
    return errs


def compare_planes(got, want, tol=FIELD_TOL) -> float:
    """max|Δ|/max|want| of one array, asserted ≤ tol."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))
    assert err <= tol, f"max|Δ|/max = {err:.3e} > {tol:.0e}"
    return err


def memory(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes") if hasattr(m, k)}


def ocean_cfg(n: int):
    from tpu_ocean.config import OCEAN_DEMO
    return OCEAN_DEMO.replace(resolution=n, length=float(n))


def compare_ocean(got, want, n: int) -> dict:
    """compare_fields for an ocean_cfg(n) solver's fields."""
    cfg = ocean_cfg(n)
    return compare_fields(got, want, cfg.choppiness, cfg.length / n)


def run_ocean(device, n: int, steps: int, **switches):
    """``steps`` OceanSolver steps on ``device`` from PRNGKey(SEED); returns
    (host fields of the last step, solver, device state)."""
    import jax
    from tpu_ocean.solver import OceanSolver
    with jax.default_device(device):
        solver = OceanSolver(ocean_cfg(n), **switches)
        state = solver.init(jax.random.PRNGKey(SEED))
        for _ in range(steps):
            state, fields = solver.step(state, 1.0 / 60.0)
        return _host(fields), solver, state


# ------------------------------------------------------------------ phases

def phase_main_path(dev, n: int = 1024, steps: int = 8) -> dict:
    """The CLI main path in process, then the same step compiled alone."""
    import jax
    import jax.numpy as jnp
    from tpu_ocean import demo
    from tpu_ocean.solver import OceanSolver, PRODUCTION
    with tempfile.TemporaryDirectory() as out:
        rc = demo.main(["ocean", "--production", "--res", str(n),
                        "--steps", str(steps), "--out", out])
        assert rc == 0, f"demo exited {rc}"
        assert os.path.getsize(os.path.join(out, "ocean_render.png")) > 0
    with jax.default_device(dev):
        solver = OceanSolver(ocean_cfg(n), **PRODUCTION)
        state = solver.init(jax.random.PRNGKey(SEED))
        dt = jnp.float32(1.0 / 60.0)
        t0 = time.perf_counter()
        compiled = solver._step_jit.lower(state, dt, solver._consts).compile()
        compile_s = time.perf_counter() - t0
        state, fields = compiled(state, dt, solver._consts)     # warm-up
        jax.block_until_ready(fields)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, fields = compiled(state, dt, solver._consts)
        jax.block_until_ready(fields)
        ms = (time.perf_counter() - t0) / steps * 1e3
    return {"res": n, "compile_s": compile_s, "memory": memory(compiled),
            "ms_per_step": ms, "device": dev.device_kind}


def phase_compare(dev, ref_dev, n: int = 1024, steps: int = 3) -> dict:
    from tpu_ocean.solver import PRODUCTION
    full = dict(PRODUCTION, half_spectrum=False)
    ship, _, _ = run_ocean(dev, n, steps, **PRODUCTION)
    out = {"shipping_vs_cpu_full": compare_ocean(
        ship, run_ocean(ref_dev, n, steps, **full)[0], n)}
    out["unpacked_complex_vs_cpu"] = compare_ocean(
        run_ocean(dev, n, steps)[0], run_ocean(ref_dev, n, steps)[0], n)
    out["real_vs_complex_state"] = compare_ocean(
        ship, run_ocean(dev, n, steps, **dict(PRODUCTION,
                                              real_state=False))[0], n)
    return out


def phase_oracle(dev) -> dict:
    import jax
    rb = _load("bench/run_baselines.py", "run_baselines")
    with jax.default_device(dev):
        results = [rb.config1()] + rb.config2()
    bad = [r for r in results if not r["pass"]]
    assert not bad, f"oracle configs failed: {bad}"
    return {r["desc"]: r["max_rel_err"] for r in results}


def phase_largest(dev, ref_dev, n: int = 8192, steps: int = 3) -> dict:
    import jax
    import jax.numpy as jnp
    from tpu_ocean.solver import OceanSolver, PRODUCTION
    with jax.default_device(dev):
        solver = OceanSolver(ocean_cfg(n), **PRODUCTION)
        state = solver.init(jax.random.PRNGKey(SEED))
        dt = jnp.float32(1.0 / 60.0)
        compiled = solver._step_jit.lower(state, dt, solver._consts).compile()
        first = None
        for k in range(steps):
            state, fields = compiled(state, dt, solver._consts)
            if k == 0:
                first = _host(fields)
        finite = bool(jax.jit(lambda f: jnp.all(jnp.stack(
            [jnp.all(jnp.isfinite(x)) for x in jax.tree.leaves(f)])))(fields))
        assert finite, "non-finite fields"
        peak = dev.memory_stats().get("peak_bytes_in_use") \
            if dev.platform != "cpu" else None
    want, _, _ = run_ocean(ref_dev, n, 1, **PRODUCTION)
    return {"res": n, "memory": memory(compiled), "peak_bytes_in_use": peak,
            "finite": finite, "step1_vs_cpu": compare_ocean(first, want, n)}


def _on_both(dev, ref_dev, fn):
    import jax
    outs = []
    for d in (dev, ref_dev):
        with jax.default_device(d):
            outs.append(_host(fn(d)))
    return outs


def _key():
    import jax
    return jax.random.PRNGKey(SEED)


def phase_cascade(dev, ref_dev, n: int = 512) -> dict:
    """The 3-band production cascade, one step; and its LOD schedule over
    4 frames (every refresh subset)."""
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    from tpu_ocean.lod import LODCascadeSolver
    from tpu_ocean.solver import PRODUCTION

    def cascade(_):
        s = CascadeSolver(default_cascade(n=n), **PRODUCTION)
        return s.step(s.init(_key()), 1.0 / 60.0)[1]

    def lod(_):
        s = LODCascadeSolver(default_cascade(n=n), periods=[4, 2, 1],
                             **PRODUCTION)
        st = s.init(_key())
        for _ in range(4):
            st, f = s.step(st)
        return f
    # cascades carry EFFECTIVE (post-choppiness) displacements over the
    # display length
    texel = max(c.length for c in default_cascade(n=n)) / n
    return {"cascade": compare_fields(*_on_both(dev, ref_dev, cascade),
                                      1.0, texel),
            "lod": compare_fields(*_on_both(dev, ref_dev, lod), 1.0, texel)}


def phase_pond(dev, ref_dev, n: int = 512, waves: int = 16) -> dict:
    from tpu_ocean.gerstner import PondSolver, WaveBank
    from tpu_ocean.config import POND_DEMO

    def pond(_):
        s = PondSolver(dataclasses.replace(POND_DEMO, resolution=n),
                       bank=WaveBank.random(SEED, waves))
        return s.fields(0.5)
    g, w = _on_both(dev, ref_dev, pond)
    out = {k: compare_planes(getattr(g, k), getattr(w, k), POND_TOL)
           for k in ("offset_x", "offset_y", "offset_z")}
    out["normal_abs"] = float(np.abs(g.normal - w.normal).max())
    assert out["normal_abs"] <= NORMAL_TOL, f"pond normals: {out}"
    return out


def phase_ensemble(dev, ref_dev, n: int = 512, members: int = 8) -> dict:
    from jax.sharding import Mesh
    from tpu_ocean.ensemble import EnsembleOceanSolver

    def ensemble(d):
        mesh = Mesh(np.asarray([d]).reshape(1, 1), ("batch", "shard"))
        s = EnsembleOceanSolver(ocean_cfg(n), mesh, ensemble_size=members)
        return s.step(s.init(_key()), 1.0 / 60.0)[1]
    return compare_ocean(*_on_both(dev, ref_dev, ensemble), n)


def phase_velocity(dev, ref_dev, n: int = 512) -> float:
    from tpu_ocean.solver import OceanSolver, PRODUCTION

    def velocity(_):
        s = OceanSolver(ocean_cfg(n), **PRODUCTION)
        st, _ = s.step(s.init(_key()), 1.0 / 60.0)
        return s.velocity(st)
    return compare_planes(*_on_both(dev, ref_dev, velocity))


def phase_invert_grad(dev, ref_dev, n: int = 64) -> dict:
    """value_and_grad of examples/invert_sea_state.py's packed loss."""
    import jax
    import jax.numpy as jnp
    inv = _load("examples/invert_sea_state.py", "invert_sea_state")

    def grad(_):
        loss, truth = inv.packed_problem(n, snapshots=2)
        zero = (jnp.zeros_like(truth.h0_re), jnp.zeros_like(truth.h0_im))
        return jax.jit(jax.value_and_grad(loss))(zero)
    (gv, gg), (wv, wg) = _on_both(dev, ref_dev, grad)
    return {"loss": compare_planes(gv, wv, GRAD_TOL),
            "grad": max(compare_planes(a, b, GRAD_TOL)
                        for a, b in zip(gg, wg))}


def phase_serve(dev, n: int = 256, frames: int = 5) -> int:
    import jax
    with jax.default_device(dev):
        return serve_frames(ocean_cfg(n), frames)


def serve_frames(cfg, frames: int) -> int:
    """FrameServer over a shipping Simulation; a client thread receives
    ``frames`` frames. Returns the count received."""
    from tpu_ocean.runtime import Simulation
    from tpu_ocean.serve import FrameServer, stream_frames
    from tpu_ocean.solver import PRODUCTION
    got, errs = [], []
    with FrameServer(Simulation(cfg, **PRODUCTION),
                     fields=("height", "foam")) as server:
        host, port = server.address

        def client():
            try:
                got.extend(stream_frames(host, port, max_frames=frames))
            except Exception as e:          # surfaced in the main thread
                errs.append(e)

        t = threading.Thread(target=client)
        t.start()
        deadline = time.monotonic() + 60
        while server.client_count == 0 and t.is_alive():
            assert time.monotonic() < deadline, "client never subscribed"
            time.sleep(0.01)
        server.run(steps=frames)
        t.join(timeout=60)
    assert not t.is_alive() and not errs, errs
    assert len(got) == frames, f"client received {len(got)}/{frames}"
    assert all(np.isfinite(p["height"]).all() for _, p in got)
    return len(got)


def phase_sharded(devs, n: int = 8192, steps: int = 3) -> dict:
    """1×len(devs) ('batch','shard') DistributedOceanSolver with the
    shipping switches vs the single-card OceanSolver on devs[0]."""
    import jax
    from jax.sharding import Mesh
    from tpu_ocean.solver_dist import DistributedOceanSolver
    from tpu_ocean.solver import PRODUCTION
    mesh = Mesh(np.asarray(devs).reshape(1, len(devs)), ("batch", "shard"))
    solver = DistributedOceanSolver(ocean_cfg(n), mesh, **PRODUCTION)
    state = solver.init(jax.random.PRNGKey(SEED))
    for _ in range(steps):
        state, fields = solver.step(state, 1.0 / 60.0)
    jax.block_until_ready(fields)
    spans = len(fields.height.sharding.device_set)
    assert spans == len(devs), f"output spans {spans} devices"
    peaks = [d.memory_stats().get("peak_bytes_in_use") for d in devs
             if d.platform != "cpu"]
    got = _host(fields)
    del state, fields
    want, _, _ = run_ocean(devs[0], n, steps, **PRODUCTION)
    return {"res": n, "mesh": dict(mesh.shape), "devices_spanned": spans,
            "peak_bytes_in_use": peaks,
            "vs_single_card": compare_ocean(got, want, n)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax
    from tpu_ocean.benchlib import card_info, enable_compile_cache
    devs = gpu_devices(args.chips)
    enable_compile_cache()
    dev = devs[0]
    cpu = jax.devices("cpu")[0]
    print(f"# device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}", flush=True)
    print(f"# nvidia-smi: {card_info()}", flush=True)

    if args.chips == 4:
        phases = [("sharded_8192", phase_sharded, (devs,))]
    else:
        phases = [("main_path", phase_main_path, (dev,)),
                  ("compare_1024", phase_compare, (dev, cpu)),
                  ("oracle", phase_oracle, (dev,)),
                  ("largest_8192", phase_largest, (dev, cpu)),
                  ("cascade_lod", phase_cascade, (dev, cpu)),
                  ("pond", phase_pond, (dev, cpu)),
                  ("ensemble", phase_ensemble, (dev, cpu)),
                  ("velocity", phase_velocity, (dev, cpu)),
                  ("invert_grad", phase_invert_grad, (dev, cpu)),
                  ("serve", phase_serve, (dev,))]
    failed = run_phases(phases)
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
