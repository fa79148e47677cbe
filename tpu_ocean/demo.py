"""Demo runner — the reference's three scenes as a CLI (L5, SURVEY.md §2.4).

    python -m tpu_ocean ocean   [--steps K] [--res N] [--out DIR]
    python -m tpu_ocean fftmesh [--steps K] [--out DIR]
    python -m tpu_ocean pond    [--steps K] [--waves W] [--out DIR]

Each command steps the corresponding preset (Ocean Demo.unity / FFT
Mesh.unity / Pond.unity parameter sets, encoded in config.py) and exports
field snapshots — PNG heatmaps plus a shaded render for the ocean — the
headless stand-in for watching the Unity scene. Metrics stream to stderr
as JSONL (observe.Metrics).
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import numpy as np


def _add_common(p, default_steps):
    p.add_argument("--steps", type=int, default=default_steps)
    p.add_argument("--out", type=str, default="out")
    p.add_argument("--dump-every", type=int, default=0,
                   help="write snapshots every K steps (0 = final only)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--backend", type=str, default="reference")
    p.add_argument("--seed", type=int, default=0)


def run_ocean(args) -> int:
    from tpu_ocean.config import OCEAN_DEMO
    from tpu_ocean.solver import OceanSolver, PRODUCTION
    from tpu_ocean.observe import Metrics
    from tpu_ocean import viz

    cfg = OCEAN_DEMO
    if args.res:
        cfg = cfg.replace(resolution=args.res, length=float(args.res))
    kw = {}
    if args.production:
        args.backend = "reference"
        kw = PRODUCTION
    solver = OceanSolver(cfg, fft_backend=args.backend, **kw)
    state = solver.init(jax.random.PRNGKey(args.seed))
    metrics = Metrics(grid_points=cfg.resolution ** 2, emit=sys.stderr)
    mgr = None
    if args.checkpoint_every:
        from tpu_ocean.checkpoint import CheckpointManager
        mgr = CheckpointManager(os.path.join(args.out, "ckpt"),
                                interval=args.checkpoint_every)
    fields = None
    for k in range(args.steps):
        with metrics.measure():
            state, fields = solver.step(state, 1.0 / 60.0)
            jax.block_until_ready(fields.height)
        if mgr is not None:
            # host-tracked step: pulling state.step would sync every frame
            mgr.maybe_save(state, cfg, step=k + 1)
        if args.dump_every and (k + 1) % args.dump_every == 0:
            viz.save_render_png(
                os.path.join(args.out, f"ocean_render_{k + 1:06d}.png"), fields)
    if fields is not None:
        viz.save_fields(args.out, fields, prefix="ocean", step=args.steps)
        viz.save_render_png(os.path.join(args.out, "ocean_render.png"), fields)
        if args.save_mesh:
            p = viz.save_mesh_obj(os.path.join(args.out, "ocean_mesh.obj"),
                                  fields, cfg,
                                  decimate=max(1, cfg.resolution // 256))
            print(f"# mesh written: {p}", file=sys.stderr)
        if args.save_clipmap:
            p = viz.save_clipmap_obj(
                os.path.join(args.out, "ocean_clipmap.obj"), fields, cfg,
                camera=(0.0, 0.0), levels=3,
                fine_cells=max(4, min(64, cfg.resolution // 8) // 4 * 4))
            print(f"# clipmap written: {p}", file=sys.stderr)
    print(f"# {args.steps} steps at {cfg.resolution}^2: "
          f"{metrics.summary()}", file=sys.stderr)
    return 0


def run_fftmesh(args) -> int:
    """The CPU-oracle scene (FFT Mesh.unity): runs BOTH the oracle and the
    solver on the same h0 and reports their agreement — the reference's
    visual cross-check, quantified."""
    from tpu_ocean.config import FFT_MESH_DEMO
    from tpu_ocean.solver import OceanSolver
    from tpu_ocean.oracle import Oracle
    from tpu_ocean import viz

    cfg = FFT_MESH_DEMO
    oracle = Oracle(cfg, rng=np.random.default_rng(args.seed))
    solver = OceanSolver(cfg, eval_mode="direct")
    state = solver.init(h0=oracle.h0.astype(np.complex64),
                        h0_conj=oracle.h0_conj.astype(np.complex64))
    t = args.steps * (1.0 / 60.0) / cfg.t_division
    ref = oracle.fields(t)
    got = solver.fields_at(state, t)
    scale = np.max(np.abs(ref.height)) + 1e-12
    err = np.max(np.abs(np.asarray(got.height) - ref.height)) / scale
    viz.save_fields(args.out, got, prefix="fftmesh", step=args.steps)
    print(f"# oracle-vs-solver max rel height error at t={t:.4f}: {err:.3e}",
          file=sys.stderr)
    return 0 if err < 1e-3 else 1


def run_pond(args) -> int:
    from tpu_ocean.config import POND_DEMO
    from tpu_ocean.gerstner import PondSolver, WaveBank
    from tpu_ocean.observe import Metrics
    from tpu_ocean import viz

    import dataclasses
    cfg = POND_DEMO
    if args.res:
        cfg = dataclasses.replace(cfg, resolution=args.res)
    bank = (WaveBank.random(args.seed, args.waves) if args.waves
            else WaveBank.from_packed4(cfg))
    solver = PondSolver(cfg, bank=bank)
    metrics = Metrics(grid_points=cfg.resolution ** 2, emit=sys.stderr)
    fields = None
    for k in range(args.steps):
        with metrics.measure():
            fields = solver.fields(k / 60.0)
            jax.block_until_ready(fields.offset_y)
    if fields is not None:
        viz.save_fields(args.out, fields, prefix="pond", step=args.steps)
        viz.save_pond_render_png(os.path.join(args.out, "pond_render.png"),
                                 fields)
        # the rest of the _REFLECTIONTYPE keyword matrix + the GrabPass
        # refraction stand-in (MistralWaterCommon.cginc:73-195)
        viz.save_pond_render_png(
            os.path.join(args.out, "pond_render_cubemap.png"), fields,
            reflection="cubemap", refraction=True)
        viz.save_pond_render_png(
            os.path.join(args.out, "pond_render_realtime.png"), fields,
            reflection="realtime", refraction=True)
    print(f"# {args.steps} pond steps, {len(bank)} waves: "
          f"{metrics.summary()}", file=sys.stderr)
    return 0


def run_cascade(args) -> int:
    """Beyond-reference scene: 3-band production cascade (lengths 1000 /
    130 / 17 m), optionally LOD-scheduled by camera distance (lod.py)."""
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    from tpu_ocean.lod import LODCascadeSolver, periods_for_distance
    from tpu_ocean.solver import PRODUCTION
    from tpu_ocean.observe import Metrics
    from tpu_ocean import viz

    n = args.res or 256
    cfgs = default_cascade(n=n)
    dt = 1.0 / 60.0
    kw = dict(pack_channels=args.pack)
    if args.production:
        # the banded twin of the ocean demo's shipping switch set: ONE
        # batched C2R transform for every band's last packed channel
        args.backend = "reference"
        kw = PRODUCTION
    if args.camera > 0:
        periods = periods_for_distance(cfgs, dt,
                                       camera_distance=args.camera)
        solver = LODCascadeSolver(cfgs, periods=periods,
                                  fft_backend=args.backend, dt=dt, **kw)
        print(f"# LOD periods {periods} (camera {args.camera:.0f} m)",
              file=sys.stderr)
    else:
        solver = CascadeSolver(cfgs, fft_backend=args.backend, **kw)
    state = solver.init(jax.random.PRNGKey(args.seed))
    metrics = Metrics(grid_points=n ** 2, emit=sys.stderr)
    fields = None
    for k in range(args.steps):
        with metrics.measure():
            state, fields = (solver.step(state) if args.camera > 0
                             else solver.step(state, dt))
            jax.block_until_ready(fields.height)
        if args.dump_every and (k + 1) % args.dump_every == 0:
            viz.save_render_png(
                os.path.join(args.out, f"cascade_render_{k + 1:06d}.png"),
                fields)
    if fields is not None:
        viz.save_fields(args.out, fields, prefix="cascade", step=args.steps)
        viz.save_render_png(os.path.join(args.out, "cascade_render.png"),
                            fields)
    print(f"# {args.steps} cascade steps ({len(cfgs)} bands at {n}^2): "
          f"{metrics.summary()}", file=sys.stderr)
    return 0


def run_serve(args) -> int:
    """Serve the ocean demo as a real-time field stream (serve.py): the
    deployment shape of the reference's per-frame render loop — remote
    clients consume what Unity composited locally (OceanRenderer.cs:98-136).
    Connect with serve.stream_frames or examples/stream_client.py."""
    from tpu_ocean.config import OCEAN_DEMO
    from tpu_ocean.runtime import Simulation
    from tpu_ocean.serve import FrameServer

    cfg = OCEAN_DEMO if not args.res else OCEAN_DEMO.replace(
        resolution=args.res, length=float(args.res))
    kw = {}
    if args.real_state:
        kw["real_state"] = True
    if args.pack_channels:
        kw["pack_channels"] = True
    if args.half_spectrum:
        kw["half_spectrum"] = True
    sim = Simulation(cfg, fft_backend=args.backend, out_dir=args.out,
                     checkpoint_every=args.checkpoint_every,
                     export_every=args.dump_every,
                     seed_key=jax.random.PRNGKey(args.seed), **kw)
    with FrameServer(sim, fields=tuple(args.fields.split(",")),
                     host=args.host, port=args.port) as server:
        host, port = server.address
        print(f"# serving {cfg.resolution}^2 [{args.fields}] on "
              f"{host}:{port} ({args.steps or 'unlimited'} steps)",
              file=sys.stderr)
        server.run(steps=args.steps or None)
    return 0


def main(argv=None) -> int:
    from tpu_ocean.benchlib import enable_compile_cache
    ap = argparse.ArgumentParser(prog="tpu_ocean")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ocean", help="GPU ocean demo (Ocean Demo.unity)")
    _add_common(p, default_steps=60)
    p.add_argument("--res", type=int, default=0,
                   help="override resolution (default: preset 1024)")
    p.add_argument("--production", action="store_true",
                   help="shipping switch set (real_state + packing + "
                        "half-spectrum on the reference FFT — the bench.py "
                        "headline pipeline)")
    p.add_argument("--save-mesh", action="store_true",
                   help="write the final displaced frame as OBJ geometry "
                        "(two-triangles-per-quad, OceanRenderer.cs:172-207; "
                        "auto-decimated to ≤ 256 vertices per side)")
    p.add_argument("--save-clipmap", action="store_true",
                   help="write a camera-adaptive multi-resolution OBJ "
                        "(crack-free concentric rings — the tessellation "
                        "falloff of MistralWaterCommon.cginc:215-296 as "
                        "actual geometry)")

    p = sub.add_parser("fftmesh", help="CPU oracle scene (FFT Mesh.unity)")
    _add_common(p, default_steps=10)

    p = sub.add_parser("pond", help="Gerstner pond (Pond.unity)")
    _add_common(p, default_steps=60)
    p.add_argument("--res", type=int, default=0)
    p.add_argument("--waves", type=int, default=0,
                   help="random W-wave bank instead of the demo's packed 4")

    p = sub.add_parser("cascade",
                       help="multi-band cascade (beyond-reference), "
                            "optionally LOD-scheduled via --camera")
    _add_common(p, default_steps=60)
    p.add_argument("--res", type=int, default=0)
    p.add_argument("--camera", type=float, default=0.0,
                   help="camera distance in m (>0 enables LOD scheduling)")
    p.add_argument("--pack", action="store_true",
                   help="Hermitian channel packing (B×2 transforms)")
    p.add_argument("--production", action="store_true",
                   help="shipping banded switch set (real_state + "
                        "packing + half-spectrum)")

    p = sub.add_parser("serve",
                       help="stream solver fields to TCP clients "
                            "(real-time drop policy; serve.py)")
    _add_common(p, default_steps=0)
    p.add_argument("--res", type=int, default=0)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral (printed on stderr)")
    p.add_argument("--fields", type=str, default="height,foam",
                   help="comma-separated OceanFields leaves to stream")
    p.add_argument("--real-state", action="store_true",
                   help="all-f32 solver state (the production/serving "
                        "shape — solver.OceanStateReal)")
    p.add_argument("--pack-channels", action="store_true",
                   help="Hermitian channel packing (docs/parity.md ledger)")
    p.add_argument("--half-spectrum", action="store_true",
                   help="C2R route for the last packed channel (needs "
                        "--pack-channels)")

    args = ap.parse_args(argv)
    enable_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    return {"ocean": run_ocean, "fftmesh": run_fftmesh,
            "pond": run_pond, "cascade": run_cascade,
            "serve": run_serve}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
