"""Demo CLI + viz + observe smoke coverage (the reference's scenes, headless)."""

import glob
import io
import json
import os

import numpy as np
import jax

from tpu_ocean.demo import main
from tpu_ocean.observe import Metrics, check_finite
from tpu_ocean import viz


def test_ocean_demo_cli(tmp_path):
    rc = main(["ocean", "--res", "32", "--steps", "3",
               "--out", str(tmp_path), "--checkpoint-every", "2",
               "--dump-every", "2"])
    assert rc == 0
    assert glob.glob(str(tmp_path / "ocean_height_*.npy"))
    assert glob.glob(str(tmp_path / "ocean_render.png"))
    assert glob.glob(str(tmp_path / "ckpt" / "state_*.npz"))


def test_fftmesh_demo_cli(tmp_path):
    rc = main(["fftmesh", "--out", str(tmp_path)])
    assert rc == 0  # rc 1 would mean oracle/solver divergence


def test_pond_demo_cli(tmp_path):
    rc = main(["pond", "--res", "32", "--steps", "2", "--waves", "8",
               "--out", str(tmp_path)])
    assert rc == 0
    assert glob.glob(str(tmp_path / "pond_offset_y_*.png"))
    # the full _REFLECTIONTYPE keyword matrix renders
    # (MistralWaterCommon.cginc:149-195): procedural + cubemap + realtime
    assert glob.glob(str(tmp_path / "pond_render.png"))
    assert glob.glob(str(tmp_path / "pond_render_cubemap.png"))
    assert glob.glob(str(tmp_path / "pond_render_realtime.png"))


def test_shade_pond_cubemap_and_refraction():
    """viz.shade_pond(reflection='cubemap'): equirect sampling along
    reflect(-view, normal), tinted; refraction distorts the bottom sample by
    the normals. Flat water must reflect pure zenith; tilted water must not."""
    from collections import namedtuple
    F = namedtuple("F", ["height", "normal", "foam"])
    n = 16
    flat = F(height=np.zeros((n, n), np.float32),
             normal=np.broadcast_to(
                 np.asarray([0.0, 1.0, 0.0], np.float32), (n, n, 3)).copy(),
             foam=np.zeros((n, n), np.float32))
    env = viz.procedural_sky_equirect(16, 32)
    rgb = viz.shade_pond(flat, reflection="cubemap", cubemap=env)
    assert rgb.shape == (n, n, 3)
    assert np.isfinite(rgb).all() and (rgb >= 0).all() and (rgb <= 1).all()
    # flat normals → reflect(-view,n) = +y → every texel samples the zenith
    # row; the fresnel-weighted sky term is spatially constant
    assert np.ptp(rgb.reshape(-1, 3), axis=0).max() < 1e-9

    tilted = np.asarray([0.35, 0.85, 0.4], np.float64)
    tilted /= np.linalg.norm(tilted)
    tilt = F(height=np.zeros((n, n), np.float32),
             normal=np.broadcast_to(tilted.astype(np.float32),
                                    (n, n, 3)).copy(),
             foam=np.zeros((n, n), np.float32))
    rgb_t = viz.shade_pond(tilt, reflection="cubemap", cubemap=env,
                           cube_tint=(1.0, 0.2, 0.2))
    assert np.abs(rgb_t - rgb).max() > 1e-3       # tint + direction differ

    # refraction: the bottom checker shows through shallow water and the
    # image differs from the flat depth-fog base
    rgb_r = viz.shade_pond(tilt, refraction=True)
    rgb_p = viz.shade_pond(tilt)
    assert np.abs(rgb_r - rgb_p).max() > 1e-3
    assert np.isfinite(rgb_r).all()

    import pytest
    with pytest.raises(ValueError, match="reflection"):
        viz.shade_pond(flat, reflection="screenspace")


def test_shade_pond_realtime_planar_reflection():
    """reflection='realtime' (_REFLECTIONTYPE_REALTIME, MistralWaterCommon
    .cginc:153-159): the scene frame is MIRRORED about the water plane and
    sampled at normal-distorted projected texels. A marker placed at scene
    row r must appear (on flat water, zero distortion) at row N-1-r."""
    from collections import namedtuple
    F = namedtuple("F", ["height", "normal", "foam"])
    n = 16
    flat = F(height=np.zeros((n, n), np.float32),
             normal=np.broadcast_to(
                 np.asarray([0.0, 1.0, 0.0], np.float32), (n, n, 3)).copy(),
             foam=np.zeros((n, n), np.float32))
    scene = np.zeros((n, n, 3))
    scene[3, :, 0] = 1.0                      # red marker stripe at row 3
    refl = viz.planar_reflection(scene, np.asarray(flat.normal, np.float64),
                                 distortion=0.0)
    assert refl[n - 1 - 3, 0, 0] == 1.0       # mirrored about the water line
    assert refl[3, 0, 0] == 0.0

    # through shade_pond: the mirrored marker row carries more red than the
    # rest of the frame (fresnel-weighted but nonzero on flat water)
    rgb = viz.shade_pond(flat, reflection="realtime", scene=scene)
    assert rgb.shape == (n, n, 3)
    base = viz.shade_pond(flat, reflection="realtime",
                          scene=np.zeros((n, n, 3)))
    assert (rgb[n - 1 - 3] - base[n - 1 - 3])[:, 0].min() > 0
    np.testing.assert_allclose(rgb[5], base[5])

    # tilted water perturbs the sampled texel (the tex2Dproj bump offset)
    tilted = np.asarray([0.3, 0.9, 0.0], np.float64)
    tilted /= np.linalg.norm(tilted)
    tilt = F(height=np.zeros((n, n), np.float32),
             normal=np.broadcast_to(tilted.astype(np.float32),
                                    (n, n, 3)).copy(),
             foam=np.zeros((n, n), np.float32))
    refl_t = viz.planar_reflection(scene, np.asarray(tilt.normal, np.float64),
                                   distortion=8.0)
    assert not np.array_equal(refl_t, refl)
    # default scene: renders finite without any asset
    rgb_d = viz.shade_pond(tilt, reflection="realtime")
    assert np.isfinite(rgb_d).all() and (rgb_d >= 0).all()


def test_cascade_demo_cli(tmp_path):
    rc = main(["cascade", "--res", "32", "--steps", "3",
               "--out", str(tmp_path)])
    assert rc == 0
    assert glob.glob(str(tmp_path / "cascade_height_*.npy"))
    assert glob.glob(str(tmp_path / "cascade_render.png"))


def test_cascade_demo_cli_lod(tmp_path):
    rc = main(["cascade", "--res", "32", "--steps", "4",
               "--camera", "400", "--out", str(tmp_path)])
    assert rc == 0
    assert glob.glob(str(tmp_path / "cascade_render.png"))


def test_metrics_emitters():
    buf = io.StringIO()
    m = Metrics(grid_points=16, emit=buf, emit_format="jsonl")
    for _ in range(3):
        with m.measure(extra_field=1):
            pass
    lines = [json.loads(l) for l in buf.getvalue().splitlines()]
    assert len(lines) == 3 and lines[0]["extra_field"] == 1
    s = m.summary(warmup=1)
    assert s["steps"] == 2 and s["updates_per_s"] > 0

    buf = io.StringIO()
    m = Metrics(grid_points=16, emit=buf, emit_format="csv")
    with m.measure():
        pass
    assert buf.getvalue().splitlines()[0].startswith("step,")


def test_check_finite_raises():
    import pytest
    ok = {"a": np.ones(3), "b": np.zeros(2)}
    check_finite(ok)
    bad = {"a": np.asarray([1.0, np.nan])}
    with pytest.raises(FloatingPointError):
        check_finite(bad)


def test_shade_ocean_shapes():
    class F:
        normal = np.tile(np.asarray([0.0, 1.0, 0.0]), (8, 8, 1))
        foam = np.zeros((8, 8))
    rgb = viz.shade_ocean(F)
    assert rgb.shape == (8, 8, 3)
    assert rgb.min() >= 0 and rgb.max() <= 1


def test_profile_trace_writes_artifacts(tmp_path):
    from tpu_ocean.observe import profile_trace
    from tpu_ocean import OceanConfig, OceanSolver
    s = OceanSolver(OceanConfig(resolution=16, length=16.0, wind=(5.0, 3.0),
                                amplitude=0.1))
    st = s.init()
    with profile_trace(str(tmp_path)):
        st, f = s.step(st, 1 / 60)
        jax.block_until_ready(f.height)
    found = []
    for root, _, files in os.walk(str(tmp_path)):
        found += files
    assert found, "profiler wrote nothing"


def test_serve_cli_runs_headless(tmp_path, capsys):
    """`python -m tpu_ocean serve --steps K` runs the solver loop with no
    clients (no broadcast work) and exits cleanly."""
    rc = main(["serve", "--res", "32", "--steps", "3",
               "--out", str(tmp_path)])
    assert rc == 0
    assert "serving 32^2" in capsys.readouterr().err


def test_serve_cli_real_state_packed(tmp_path, capsys):
    """--real-state --pack-channels --half-spectrum: the CLI serves the
    production shape (all-f32 state, packed, C2R last channel)."""
    rc = main(["serve", "--res", "32", "--steps", "2", "--real-state",
               "--pack-channels", "--half-spectrum", "--out", str(tmp_path)])
    assert rc == 0
    assert "serving 32^2" in capsys.readouterr().err


def test_ocean_demo_cli_production(tmp_path):
    """`ocean --production`: the shipping switch set on jnp.fft, writing
    PNG files that carry the PNG signature and decode to the field size."""
    import struct
    import zlib
    rc = main(["ocean", "--production", "--res", "32", "--steps", "2",
               "--out", str(tmp_path)])
    assert rc == 0
    with open(tmp_path / "ocean_render.png", "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (32, 32)
    # IDAT inflates to h rows of (filter byte + 3·w RGB bytes)
    start = data.index(b"IDAT") + 4
    length = struct.unpack(">I", data[start - 8:start - 4])[0]
    raw = zlib.decompress(data[start:start + length])
    assert len(raw) == h * (1 + 3 * w)


def test_write_png_and_colormap():
    """viz.write_png / colormap: grey and RGB images round-trip through
    zlib, and the colour map spans viridis' dark-purple → yellow ends."""
    import zlib
    import numpy as np
    import tempfile, os
    c = viz.colormap(np.asarray([0.0, 1.0]))
    assert c.shape == (2, 3) and c.dtype == np.uint8
    assert c[0, 2] > c[0, 1] and c[1, 0] > 200 and c[1, 1] > 200
    with tempfile.TemporaryDirectory() as d:
        for img in (np.arange(12, dtype=np.uint8).reshape(3, 4),
                    np.zeros((2, 5, 3), np.uint8)):
            p = viz.write_png(os.path.join(d, "t.png"), img)
            data = open(p, "rb").read()
            start = data.index(b"IDAT") + 4
            n = int.from_bytes(data[start - 8:start - 4], "big")
            raw = zlib.decompress(data[start:start + n])
            rows = np.frombuffer(raw, np.uint8).reshape(img.shape[0], -1)
            assert (rows[:, 0] == 0).all()
            np.testing.assert_array_equal(rows[:, 1:].reshape(img.shape),
                                          img)
    import pytest
    with pytest.raises(ValueError, match="write_png"):
        viz.write_png("unused.png", np.zeros((2, 2, 4), np.uint8))
