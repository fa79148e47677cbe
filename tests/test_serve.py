"""Frame serving (tpu_ocean/serve.py): wire protocol round-trip, trajectory
fidelity vs an offline run of the same seed, and the real-time drop policy
(the solver loop must never block on a slow client)."""

import json
import os
import socket
import threading

import numpy as np
import pytest

from tpu_ocean.config import OceanConfig
from tpu_ocean.runtime import Simulation
from tpu_ocean.serve import FrameServer, stream_frames, PROTO

CFG = OceanConfig(resolution=64, length=64.0, wind=(8.0, 5.0), amplitude=0.5,
                  spectrum_layout="fft", normals_mode="stencil")


def test_stream_matches_offline_trajectory():
    fields = ("height", "normal", "foam")
    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=fields) as server:
        host, port = server.address
        frames = []
        client_err = []

        def client():
            try:
                frames.extend(stream_frames(host, port, max_frames=3))
            except Exception as e:       # surface in the main thread
                client_err.append(e)

        t = threading.Thread(target=client)
        t.start()
        # wait for the subscription so no frame precedes the client
        while server.client_count == 0 and t.is_alive():
            pass
        server.run(steps=5)
        t.join(timeout=30)
        assert not t.is_alive() and not client_err, client_err

    assert [m["step"] for m, _ in frames] == [1, 2, 3]
    assert frames[0][1]["height"].shape == (64, 64)
    assert frames[0][1]["normal"].shape == (64, 64, 3)

    # the wire carries exactly the offline trajectory (same seed, same math)
    offline = Simulation(CFG, fft_backend="matmul")
    for meta, planes in frames:
        out = offline.step()
        assert meta["t"] == pytest.approx(meta["step"] * offline.dt)
        for name in fields:
            np.testing.assert_array_equal(planes[name],
                                          np.asarray(getattr(out, name)))


def test_slow_client_drops_frames_not_blocks():
    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=("height", "foam"), queue_frames=1) as server:
        host, port = server.address
        # subscribe but never read — with a tiny receive window so the
        # kernel cannot absorb the stream: the sender blocks, the 1-frame
        # queue overflows → drops, never backpressure on the solver loop
        lazy = socket.socket()
        lazy.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        lazy.connect((host, port))
        try:
            while server.client_count == 0:
                pass
            server.run(steps=64)         # must complete promptly
            assert server.dropped_frames > 0
        finally:
            lazy.close()


def test_serves_sharded_simulation():
    """A domain-decomposed Simulation streams identically — device_get
    gathers the Z-sharded field shards into the same wire planes."""
    from tpu_ocean.parallel.mesh import make_mesh
    sharded = Simulation(CFG, fft_backend="matmul", mesh=make_mesh(shard=8))
    with FrameServer(sharded, fields=("height",)) as server:
        host, port = server.address
        frames = []
        t = threading.Thread(target=lambda: frames.extend(
            stream_frames(host, port, max_frames=2)))
        t.start()
        while server.client_count == 0 and t.is_alive():
            pass
        server.run(steps=3)
        t.join(timeout=30)
        assert not t.is_alive()

    offline = Simulation(CFG, fft_backend="matmul")
    for _, planes in frames:
        out = offline.step()
        np.testing.assert_allclose(planes["height"], np.asarray(out.height),
                                   rtol=1e-5, atol=1e-5)


def test_serves_cascade_simulation():
    """CascadeSimulation satisfies the same serving contract (cfg/dt/step):
    the combined multi-band surface streams like a single-patch one, and
    the advertised length is the cascade's display_length (= max band), not
    band 0's — bands here are ordered shortest-first to pin that."""
    from tpu_ocean.runtime import CascadeSimulation
    from tpu_ocean.cascade import default_cascade
    sim = CascadeSimulation(default_cascade(n=32,
                                            lengths=(17.0, 130.0, 1000.0)),
                            fft_backend="reference")
    with FrameServer(sim, fields=("height", "foam")) as server:
        host, port = server.address
        frames = []
        t = threading.Thread(target=lambda: frames.extend(
            stream_frames(host, port, max_frames=2)))
        t.start()
        while server.client_count == 0 and t.is_alive():
            pass
        server.run(steps=3)
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(frames) == 2
    assert frames[0][1]["height"].shape == (32, 32)
    assert np.isfinite(frames[0][1]["height"]).all()

    # header check on the raw wire: the planes span 1000 m, not 17 m
    import json as _json
    sim2 = CascadeSimulation(default_cascade(n=32,
                                             lengths=(17.0, 130.0, 1000.0)),
                             fft_backend="reference")
    with FrameServer(sim2, fields=("height",)) as srv:
        with socket.create_connection(srv.address) as conn:
            header = _json.loads(conn.makefile("rb").readline())
    assert header["length"] == 1000.0


def test_rejects_unknown_field_and_foreign_stream():
    with pytest.raises(ValueError, match="stream"):
        FrameServer(Simulation(CFG, fft_backend="matmul"),
                    fields=("height", "vorticity"))

    imposter = socket.create_server(("127.0.0.1", 0))
    host, port = imposter.getsockname()

    def fake():
        conn, _ = imposter.accept()
        conn.sendall(json.dumps({"proto": "nope/9"}).encode() + b"\n")
        conn.close()

    t = threading.Thread(target=fake, daemon=True)
    t.start()
    with pytest.raises(ConnectionError, match="tpu-ocean"):
        list(stream_frames(host, port, max_frames=1))
    imposter.close()
    assert PROTO == "tpu-ocean/1"


def test_native_cpp_client_consumes_stream():
    """The dependency-free C++ client (native/stream_client.cpp — the
    engine-side consumer a production deployment embeds) reads the header
    and N intact frames from a live FrameServer."""
    import shutil
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    binary = os.path.join(root, "native", "tpu_ocean_stream_client")
    if not os.path.exists(binary):
        make = shutil.which("make")
        if make is None:
            pytest.skip("no make; native client not built")
        subprocess.run([make, "-C", os.path.join(root, "native")],
                       check=True, capture_output=True)

    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=("height", "normal", "foam")) as server:
        host, port = server.address
        proc = subprocess.Popen([binary, host, str(port), "3"],
                                stdout=subprocess.PIPE, text=True)
        while server.client_count == 0 and proc.poll() is None:
            pass
        server.run(steps=5)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out[-800:]
    assert "received 3/3 frames" in out
    assert out.count("height in [") == 3


def test_streams_computed_velocity_plane():
    """'velocity' is a computed wire field (solver.velocity, not an
    OceanFields leaf): the streamed plane equals the solver's analytic
    ∂h/∂t at the same state."""
    sim = Simulation(CFG, fft_backend="matmul")
    with FrameServer(sim, fields=("height", "velocity")) as server:
        host, port = server.address
        frames = []
        t = threading.Thread(target=lambda: frames.extend(
            stream_frames(host, port, max_frames=2)))
        t.start()
        while server.client_count == 0 and t.is_alive():
            pass
        server.run(steps=3)
        t.join(timeout=30)
        assert not t.is_alive()
    assert frames[-1][1]["velocity"].shape == (64, 64)
    assert np.isfinite(frames[-1][1]["velocity"]).all()
    offline = Simulation(CFG, fft_backend="matmul")
    for meta, planes in frames:
        offline.step()
        want = np.asarray(offline.solver.velocity(offline.state))
        np.testing.assert_array_equal(planes["velocity"], want)


# ------------------------------------------------- spatial LOD (r3 #7 / M1)

def test_lod_divisor_for_distance_rule():
    from tpu_ocean.serve import lod_divisor_for_distance
    # at/below the reference distance: full grid
    assert lod_divisor_for_distance(50.0, 64.0, 64) == 1
    assert lod_divisor_for_distance(100.0, 64.0, 64) == 1
    # each doubling halves the served resolution
    assert lod_divisor_for_distance(200.0, 64.0, 64) == 2
    assert lod_divisor_for_distance(400.0, 64.0, 64) == 4
    # capped, and clamped so the served plane keeps >= 8 texels
    assert lod_divisor_for_distance(1e6, 64.0, 64) == 8
    assert lod_divisor_for_distance(1e6, 64.0, 16) == 2
    # non-dividing divisors fall back to the next dividing power of two
    assert lod_divisor_for_distance(400.0, 64.0, 24) == 2


def test_decimate_plane_pools_and_renormalizes():
    from tpu_ocean.serve import decimate_plane
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 16)).astype(np.float32)
    y = decimate_plane(x, 4, "height")
    assert y.shape == (4, 4)
    np.testing.assert_allclose(y[0, 0], x[:4, :4].mean(), rtol=1e-6)
    nrm = rng.normal(size=(16, 16, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    yn = decimate_plane(nrm, 2, "normal")
    assert yn.shape == (8, 8, 3)
    np.testing.assert_allclose(np.linalg.norm(yn, axis=-1), 1.0, atol=1e-5)


def test_client_lod_request_serves_decimated_planes():
    """A client requesting lod=2 receives (N/2)-planes that equal the
    mean-pooled full planes of the same trajectory — the serving analogue
    of the reference's distance tessellation (MistralWaterCommon.cginc:
    215-296)."""
    from tpu_ocean.serve import decimate_plane
    fields = ("height", "normal", "foam")
    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=fields) as server:
        host, port = server.address
        frames = []
        client_err = []

        def client():
            try:
                frames.extend(stream_frames(host, port, max_frames=2, lod=2))
            except Exception as e:
                client_err.append(e)

        t = threading.Thread(target=client)
        t.start()
        while server.client_count == 0 and t.is_alive():
            pass
        server.run(steps=4)
        t.join(timeout=30)
        assert not t.is_alive() and not client_err, client_err

    assert frames[0][1]["height"].shape == (32, 32)
    assert frames[0][1]["normal"].shape == (32, 32, 3)
    offline = Simulation(CFG, fft_backend="matmul")
    for meta, planes in frames:
        out = offline.step()
        for name in fields:
            want = decimate_plane(np.asarray(getattr(out, name)), 2, name)
            np.testing.assert_allclose(planes[name], want, atol=1e-6)


def test_mixed_lod_clients_each_get_their_resolution():
    """Two concurrent clients at different divisors: payloads are built per
    divisor and routed by client; camera_distance picks the divisor server-
    side (composing with the temporal LOD's distance rule)."""
    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=("height",)) as server:
        host, port = server.address
        got = {}
        errs = []

        def client(tag, **kw):
            try:
                got[tag] = list(stream_frames(host, port, max_frames=2, **kw))
            except Exception as e:
                errs.append((tag, e))

        threads = [threading.Thread(target=client, args=("full",)),
                   threading.Thread(target=client, args=("far",),
                                    kwargs=dict(camera_distance=400.0))]
        for t in threads:
            t.start()
        while server.client_count < 2 and any(t.is_alive() for t in threads):
            pass
        server.run(steps=5)
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs

    assert got["full"][0][1]["height"].shape == (64, 64)
    assert got["far"][0][1]["height"].shape == (16, 16)   # 400m → divisor 4
    # same trajectory, coarser sampling: pooled full == far at shared steps
    from tpu_ocean.serve import decimate_plane
    full_by_step = {m["step"]: p["height"] for m, p in got["full"]}
    for meta, planes in got["far"]:
        if meta["step"] in full_by_step:
            want = decimate_plane(full_by_step[meta["step"]], 4, "height")
            # device-side pooling (serve._pool_on_device) fuses the mean
            # differently than the host twin: equal to reduction-order fp
            np.testing.assert_allclose(planes["height"], want,
                                       atol=1e-6 * max(np.abs(want).max(),
                                                       1.0))


def test_legacy_silent_client_gets_full_resolution():
    """A client that sends NOTHING (pre-LOD protocol) still receives the
    full-resolution stream after the negotiation window."""
    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=("height",)) as server:
        host, port = server.address
        sock = socket.create_connection((host, port))
        try:
            f = sock.makefile("rb")
            header = json.loads(f.readline())
            assert header["proto"] == PROTO
            assert header["resolution"] == 64
            assert header["lod"] == 1
            assert header["full_resolution"] == 64
        finally:
            sock.close()


def test_frame_stride_temporal_lod():
    """{"frame_stride": 2}: the client receives every 2nd broadcast frame
    (temporal per-client LOD) while a full-rate client sees them all."""
    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=("height",)) as server:
        host, port = server.address
        got = {}
        errs = []

        def client(tag, **kw):
            try:
                got[tag] = list(stream_frames(host, port, max_frames=3, **kw))
            except Exception as e:
                errs.append((tag, e))

        threads = [threading.Thread(target=client, args=("full",)),
                   threading.Thread(target=client, args=("slow",),
                                    kwargs=dict(frame_stride=2))]
        for t in threads:
            t.start()
        while server.client_count < 2 and any(t.is_alive() for t in threads):
            pass
        server.run(steps=8)
        server.stop()                    # EOF so max_frames never blocks
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs

    full_steps = [m["step"] for m, _ in got["full"]]
    slow_steps = [m["step"] for m, _ in got["slow"]]
    assert full_steps == [1, 2, 3]
    # every 2nd broadcast since subscription: consecutive gaps of 2
    assert len(slow_steps) == 3
    assert all(b - a == 2 for a, b in zip(slow_steps, slow_steps[1:])), \
        slow_steps


def test_streams_distributed_velocity():
    """A domain-decomposed real-state Simulation streams the computed
    velocity plane — DistributedOceanSolver.velocity on the serving path
    (complex-free end to end on the wire)."""
    from tpu_ocean.parallel.mesh import make_mesh
    mesh = make_mesh(shard=8)
    sim = Simulation(CFG, real_state=True, mesh=mesh)
    with FrameServer(sim, fields=("height", "velocity")) as server:
        host, port = server.address
        frames = []
        errs = []

        def client():
            try:
                frames.extend(stream_frames(host, port, max_frames=3))
            except Exception as e:
                errs.append(e)

        t = threading.Thread(target=client)
        t.start()
        while server.client_count == 0 and t.is_alive():
            pass
        server.run(steps=3)
        t.join(timeout=60)
        assert not t.is_alive() and not errs, errs

    assert frames[-1][0]["step"] == 3      # last frame == final sim state
    v = frames[-1][1]["velocity"]
    assert v.shape == (64, 64)
    assert np.isfinite(v).all() and np.abs(v).max() > 0
    # matches the solver's own velocity at the same state
    want = np.asarray(sim.solver.velocity(sim.state))
    np.testing.assert_allclose(v, want, atol=2e-6 * max(np.abs(want).max(),
                                                        1e-9))


@pytest.mark.parametrize("evil,want_lod", [
    (b"5\n", 1),                                   # non-dict JSON
    (b'{"lod": "huge"}\n', 1),                     # non-numeric lod
    (b'{"camera_distance": "far"}\n', 1),          # non-numeric distance
    (b'{"lod": null}\n', 1),
    (b'[1, 2]\n', 1),
    # json parses 1e999 as float inf; int(inf)/log2(inf) raised
    # OverflowError PAST the clamps and killed the handler thread (review
    # finding, r5). +inf now clamps to the COARSEST divisor (an infinitely
    # far camera gets far LOD); -inf / inf stride clamp to defaults
    (b'{"camera_distance": 1e999}\n', 8),
    (b'{"lod": 1e999}\n', 8),
    (b'{"frame_stride": 1e999}\n', 1),
    (b'{"camera_distance": -1e999}\n', 1),
])
def test_malformed_lod_request_clamps_and_server_survives(evil, want_lod):
    """Regression (ADVICE r3, high): a malformed LOD request must clamp
    for THAT client and must not kill the accept path — a second,
    well-formed client connects and streams afterwards."""
    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=("height",)) as server:
        host, port = server.address
        # evil client: sends garbage, still gets a clamped header
        with socket.create_connection((host, port)) as bad:
            bad.sendall(evil)
            header = json.loads(bad.makefile("rb").readline())
            assert header["proto"] == PROTO
            assert header["lod"] == want_lod
            assert header["frame_stride"] == 1
        # the server must still admit and serve a new client
        frames = []
        errs = []

        def client():
            try:
                frames.extend(stream_frames(host, port, max_frames=1))
            except Exception as e:
                errs.append(e)

        t = threading.Thread(target=client)
        t.start()
        while server.client_count == 0 and t.is_alive():
            pass
        server.run(steps=2)
        t.join(timeout=30)
        assert not t.is_alive() and not errs, errs
    assert len(frames) == 1


def test_concurrent_connects_admit_in_parallel():
    """Negotiation runs per-client (ADVICE r3): a silent client that waits
    out the full 0.25 s legacy window must not delay other admissions —
    k fast clients admit while the silent one is still negotiating."""
    import time
    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=("height",)) as server:
        host, port = server.address
        silent = socket.create_connection((host, port))  # says nothing
        try:
            t0 = time.monotonic()
            fast = []
            for _ in range(3):
                s = socket.create_connection((host, port))
                s.sendall(b"{}\n")       # ends negotiation immediately
                json.loads(s.makefile("rb").readline())
                fast.append(s)
            elapsed = time.monotonic() - t0
            # serialized behind the silent window this would be >= 0.25 s
            assert elapsed < 0.2, elapsed
            for s in fast:
                s.close()
        finally:
            silent.close()


def test_serves_pond_family_with_velocity():
    """The pond family (PondSimulation) streams through the same wire
    protocol: height/normal aliases plus the computed velocity plane
    (gerstner_velocity) — pond/ocean serving symmetry (VERDICT r3 #7)."""
    from tpu_ocean.config import PondConfig
    from tpu_ocean.runtime import PondSimulation
    sim = PondSimulation(PondConfig(resolution=64), dt=1 / 60)
    with FrameServer(sim, fields=("height", "normal", "velocity")) as server:
        host, port = server.address
        frames = []
        errs = []

        def client():
            try:
                frames.extend(stream_frames(host, port, max_frames=2))
            except Exception as e:
                errs.append(e)

        t = threading.Thread(target=client)
        t.start()
        while server.client_count == 0 and t.is_alive():
            pass
        server.run(steps=3)
        t.join(timeout=30)
        assert not t.is_alive() and not errs, errs

    assert frames[0][1]["height"].shape == (64, 64)
    assert frames[0][1]["normal"].shape == (64, 64, 3)
    v = frames[-1][1]["velocity"]
    assert v.shape == (64, 64) and np.isfinite(v).all() and np.abs(v).max() > 0
    # velocity equals the solver's own closed form at the frame's clock
    from tpu_ocean.gerstner import PondSolver
    offline = PondSolver(PondConfig(resolution=64))
    for meta, planes in frames:
        want = np.asarray(offline.velocity(meta["t"]))
        np.testing.assert_allclose(planes["velocity"], want, atol=1e-6)
        np.testing.assert_allclose(
            planes["height"], np.asarray(offline.fields(meta["t"]).offset_y),
            atol=1e-6)


def test_one_field_compute_and_pooled_pulls_with_mixed_lod_clients():
    """Interference bound (VERDICT r4 weak #3): the solver-side field
    compute (_device_planes, incl. the velocity derivation) runs at most
    ONCE per frame no matter how many LOD tiers are subscribed, and each
    tier's device→host transfer carries only its POOLED (N/d)² planes —
    decimation happens on device, before the pull."""
    sim = Simulation(CFG, fft_backend="matmul")
    with FrameServer(sim, fields=("height",)) as server:
        host, port = server.address
        calls = {"n": 0}
        pulled_shapes = []
        orig_dev = server._device_planes
        orig_pull = server._pulled_planes

        def counting(fields):
            calls["n"] += 1
            return orig_dev(fields)

        def recording(dev, divisor, dtype):
            out = orig_pull(dev, divisor, dtype)
            pulled_shapes.append((divisor, out["height"].shape))
            return out

        server._device_planes = counting
        server._pulled_planes = recording
        got = {}
        errs = []

        def client(tag, **kw):
            try:
                got[tag] = list(stream_frames(host, port, max_frames=2, **kw))
            except Exception as e:
                errs.append((tag, e))

        threads = [threading.Thread(target=client, args=(f"c{d}",),
                                    kwargs=dict(lod=d)) for d in (1, 2, 4)]
        for t in threads:
            t.start()
        while server.client_count < 3 and any(t.is_alive() for t in threads):
            pass
        steps = 4
        server.run(steps=steps)
        server.stop()
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs
    assert calls["n"] <= steps           # once per frame, NOT per tier
    n = CFG.resolution
    for divisor, shape in pulled_shapes:
        assert shape == (n // divisor, n // divisor)   # pooled BEFORE pull
    assert all(len(v) == 2 for v in got.values())


def test_f16_wire_halves_bytes_and_roundtrips():
    """A {"dtype": "float16"} client gets half-size planes (value-identical
    to the f32 stream within f16 precision); an f32 client on the same
    server is untouched."""
    sim = Simulation(CFG, fft_backend="matmul")
    with FrameServer(sim, fields=("height", "normal")) as server:
        host, port = server.address
        got = {}
        errs = []

        def client(tag, **kw):
            try:
                got[tag] = list(stream_frames(host, port, max_frames=2, **kw))
            except Exception as e:
                errs.append((tag, e))

        threads = [
            threading.Thread(target=client, args=("f16",),
                             kwargs=dict(dtype="float16")),
            threading.Thread(target=client, args=("f32",)),
        ]
        for t in threads:
            t.start()
        while server.client_count < 2 and any(t.is_alive() for t in threads):
            pass
        server.run(steps=4)
        server.stop()
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs
    assert len(got["f16"]) == 2 and len(got["f32"]) == 2
    by_step = {m["step"]: p for m, p in got["f32"]}
    for meta, planes in got["f16"]:
        want = by_step.get(meta["step"])
        if want is None:
            continue
        scale = max(np.abs(want["height"]).max(), 1e-6)
        # f16 has a 10-bit mantissa: ~1e-3 relative
        np.testing.assert_allclose(planes["height"], want["height"],
                                   atol=2e-3 * scale)
        assert planes["height"].dtype == np.float32   # client upcasts
    # wire accounting: the f16 header bytes-per-frame is half
    assert server._frame_bytes_for(1, "float16") * 2 == \
        server._frame_bytes_for(1, "float32")


def test_solo_strided_client_still_advances():
    """Regression: with ONLY a strided client connected, the broadcast must
    still run on its off-phase frames (it advances the stride counter) —
    skipping it froze the client's schedule forever."""
    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=("height",)) as server:
        host, port = server.address
        got = []
        errs = []

        def client():
            try:
                got.extend(stream_frames(host, port, max_frames=2,
                                         lod=2, frame_stride=2))
            except Exception as e:
                errs.append(e)

        t = threading.Thread(target=client)
        t.start()
        while server.client_count == 0 and t.is_alive():
            pass
        server.run(steps=6)
        server.stop()
        t.join(timeout=30)
        assert not errs, errs
    assert [m["step"] for m, _ in got] == [1, 3]
    assert got[0][1]["height"].shape == (32, 32)   # lod composes with stride


def test_zlib_wire_compresses_and_roundtrips():
    """A {"codec": "zlib"} client receives compressed frames (framed by
    the meta line's nbytes) that decode to the same planes the raw client
    sees; smooth ocean planes compress measurably."""
    sim = Simulation(CFG, fft_backend="matmul")
    with FrameServer(sim, fields=("height", "foam")) as server:
        host, port = server.address
        got = {}
        errs = []

        def client(tag, **kw):
            try:
                got[tag] = list(stream_frames(host, port, max_frames=2, **kw))
            except Exception as e:
                errs.append((tag, e))

        threads = [
            threading.Thread(target=client, args=("zip",),
                             kwargs=dict(codec="zlib")),
            threading.Thread(target=client, args=("raw",)),
        ]
        for t in threads:
            t.start()
        while server.client_count < 2 and any(t.is_alive() for t in threads):
            pass
        server.run(steps=4)
        server.stop()
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs
        # the payload builder really compresses: frame_payload under zlib
        # is smaller than raw for a real field frame
        f = sim.step()
        raw = server.frame_payload(f, 1, "float32", "none")
        zipped = server.frame_payload(f, 1, "float32", "zlib")
        assert len(zipped) < len(raw)
    by_step = {m["step"]: p for m, p in got["raw"]}
    matched = 0
    for meta, planes in got["zip"]:
        want = by_step.get(meta["step"])
        if want is None:
            continue
        np.testing.assert_array_equal(planes["height"], want["height"])
        np.testing.assert_array_equal(planes["foam"], want["foam"])
        matched += 1
    assert matched >= 1


def test_native_cpp_client_f16_lod_wire():
    """The C++ client negotiates the r5 wire: lod=2 + float16 planes,
    widened host-side — the production engine-side consumer of the
    device-pooled stream."""
    import shutil
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    binary = os.path.join(root, "native", "tpu_ocean_stream_client")
    if not os.path.exists(binary):
        make = shutil.which("make")
        if make is None:
            pytest.skip("no make; native client not built")
        subprocess.run([make, "-C", os.path.join(root, "native")],
                       check=True, capture_output=True)
    with FrameServer(Simulation(CFG, fft_backend="matmul"),
                     fields=("height", "foam")) as server:
        host, port = server.address
        proc = subprocess.Popen([binary, host, str(port), "2", "2",
                                 "float16"],
                                stdout=subprocess.PIPE, text=True)
        while server.client_count == 0 and proc.poll() is None:
            pass
        server.run(steps=4)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out[-800:]
    assert "received 2/2 frames" in out
    assert "f16 wire" in out
    assert "32x32" in out              # lod=2 on the 64 grid
