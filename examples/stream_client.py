"""Consume a live tpu-ocean frame stream — the renderer side of `serve`.

Launches `python -m tpu_ocean serve` in-process (or connects to --host/--port
if given), reads K frames, prints per-frame stats, and writes a shaded PNG of
the last frame — a stand-in for the remote render client a production
deployment pairs with the GPU solver host.

    python examples/stream_client.py --frames 10 --out out/stream.png
    python examples/stream_client.py --host 10.0.0.2 --port 7777
"""


# repo-root import bootstrap: these scripts run directly from a checkout
# (sys.path[0] is the script's own dir, not the repo root)
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os
import sys
import threading


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--host", type=str, default="")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", type=str, default="out/stream.png")
    ap.add_argument("--lod", type=int, default=0,
                    help="spatial LOD: power-of-two resolution divisor")
    ap.add_argument("--camera", type=float, default=0.0,
                    help="camera distance (m): the server picks the divisor")
    ap.add_argument("--stride", type=int, default=0,
                    help="temporal LOD: receive every k-th frame")
    args = ap.parse_args()

    from tpu_ocean.serve import stream_frames

    server = None
    if args.host:
        host, port = args.host, args.port
    else:
        # self-contained demo: serve the ocean preset from this process
        import jax
        from tpu_ocean.config import OCEAN_DEMO
        from tpu_ocean.runtime import Simulation
        from tpu_ocean.serve import FrameServer

        cfg = OCEAN_DEMO.replace(resolution=args.res,
                                 length=float(args.res))
        sim = Simulation(cfg, fft_backend="matmul",
                         seed_key=jax.random.PRNGKey(0))
        server = FrameServer(sim, fields=("height", "normal", "foam"))
        host, port = server.address

        def pump():
            # wait for our own subscription so no frame precedes the client,
            # then stop() → EOF so the client can never block forever even
            # if the drop policy thinned the stream below --frames
            import time
            while server.client_count == 0 and not server.stopped:
                time.sleep(0.01)
            # a strided client consumes every k-th broadcast: serve enough
            server.run(args.frames * max(1, args.stride) + 4)
            server.stop()

        pump_thread = threading.Thread(target=pump, daemon=True)
        pump_thread.start()

    last = None
    lod_kw = {}
    if args.lod:
        lod_kw["lod"] = args.lod
    if args.camera:
        lod_kw["camera_distance"] = args.camera
    if args.stride:
        lod_kw["frame_stride"] = args.stride
    for meta, planes in stream_frames(host, port, max_frames=args.frames,
                                      **lod_kw):
        h = planes["height"]
        print(f"step {meta['step']:4d}  t={meta['t']:7.3f}s  "
              f"h in [{h.min():+.3f}, {h.max():+.3f}]  "
              f"foam {planes.get('foam', h).mean():.4f}", file=sys.stderr)
        last = planes

    if server is not None:
        server.stop()
        # join the pump before interpreter teardown: a daemon thread still
        # inside a compiled sim.step() when Python exits dies mid-C++-frame
        # ("terminate called … FATAL: exception not rethrown", SIGABRT)
        pump_thread.join(timeout=30)
    if last is None:
        print("no frames received", file=sys.stderr)
        return 1

    if {"normal", "foam"} <= set(last):
        from types import SimpleNamespace
        from tpu_ocean import viz
        viz.save_render_png(args.out, SimpleNamespace(**last))
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    rc = main()
    # exit WITHOUT interpreter finalization: on this toolchain a process
    # that served frames from a background thread aborts ~25% of the time
    # during C++ runtime teardown ("terminate called … FATAL: exception not
    # rethrown", SIGABRT) AFTER all Python work — including the explicit
    # server.stop() + pump join above — has completed. The crash is
    # environmental (reproduced with the server loop alone, bisected: not
    # the sockets, not viz); os._exit skips the doomed finalizers once
    # stdio is flushed.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
