"""LOD cascade scheduling (lod.py) — beyond-reference subsystem.

Invariants:
* periods all 1 → matches plain CascadeSolver every frame (f32-fusion
  tolerance: the gather/scatter program fuses differently than the plain
  batched step, so equality is to ~1e-4 absolute, not bitwise);
* held bands' cached planes do not change between their refresh frames;
* at frames where every band refreshes, the combined fields equal the plain
  cascade's at the same frame (phase accumulation over p held frames ==
  p single-frame evolves);
* the schedule compiles one sub-step per distinct subset, not per frame.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_ocean.cascade import CascadeSolver, default_cascade
from tpu_ocean.lod import (LODCascadeSolver, nyquist_periods,
                           periods_for_distance, band_max_omega)

N = 32
DT = 1.0 / 60.0


def _bands(n=N):
    return default_cascade(n=n, lengths=(1000.0, 130.0, 17.0))


def test_all_period_one_matches_plain_cascade():
    cfgs = _bands()
    plain = CascadeSolver(cfgs)
    lod = LODCascadeSolver(cfgs, periods=[1, 1, 1], dt=DT)
    sp = plain.init()
    sl = lod.init()
    for _ in range(4):
        sp, fp = plain.step(sp, DT)
        sl, fl = lod.step(sl)
        np.testing.assert_allclose(np.asarray(fl.height),
                                   np.asarray(fp.height), rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(fl.disp_x),
                                   np.asarray(fp.disp_x), rtol=0, atol=1e-4)


def test_held_band_planes_frozen_between_refreshes():
    cfgs = _bands()
    lod = LODCascadeSolver(cfgs, periods=[4, 2, 1], dt=DT)
    st = lod.init()
    p_init = np.asarray(st.planes)            # all bands primed at t=0
    st, _ = lod.step(st)                      # frame 1: only band 2
    planes1 = np.asarray(st.planes)
    np.testing.assert_array_equal(p_init[0], planes1[0])    # held
    np.testing.assert_array_equal(p_init[1], planes1[1])    # held
    assert np.abs(planes1[2] - p_init[2]).max() > 0         # refreshed
    st, _ = lod.step(st)                      # frame 2: bands 1, 2
    planes2 = np.asarray(st.planes)
    np.testing.assert_array_equal(p_init[0], planes2[0])    # still held
    assert np.abs(planes2[1] - planes1[1]).max() > 0
    st, _ = lod.step(st)                      # frame 3: band 2
    st, _ = lod.step(st)                      # frame 4: ALL bands
    planes4 = np.asarray(st.planes)
    assert np.abs(planes4[0] - p_init[0]).max() > 0         # finally moved


def test_refresh_matches_plain_cascade_at_refresh_frames():
    """After p held frames a band's refreshed planes equal the plain
    cascade's at that frame: phase += ω·(p·dt) == p × (phase += ω·dt)."""
    cfgs = _bands()
    plain = CascadeSolver(cfgs)
    lod = LODCascadeSolver(cfgs, periods=[4, 2, 1], dt=DT)
    sp = plain.init()
    sl = lod.init()
    for f in range(1, 9):
        sp, fp = plain.step(sp, DT)
        sl, fl = lod.step(sl)
        if f % 4 == 0:
            # every band fresh at this frame → full combined fields agree
            np.testing.assert_allclose(np.asarray(fl.height),
                                       np.asarray(fp.height),
                                       rtol=0, atol=1e-4)
    # f=8 refreshed every band → all phases equal the 8-step trajectory
    np.testing.assert_allclose(np.asarray(sl.cascade.phase),
                               np.asarray(sp.phase), rtol=0, atol=1e-5)


def test_substep_cache_is_per_subset():
    cfgs = _bands()
    lod = LODCascadeSolver(cfgs, periods=[4, 2, 1], dt=DT)
    # slots: 0 → {0,1,2}, 1 → {2}, 2 → {1,2}, 3 → {2}: 3 distinct subsets
    assert lod.schedule_len == 4
    assert len(lod._substeps) == 3
    assert set(lod._slots) == {(0, 1, 2), (2,), (1, 2)}


def test_nyquist_periods_monotone_in_patch_length():
    cfgs = _bands()
    ps = nyquist_periods(cfgs, DT)
    # longer patch → slower ω_max → period at least as large
    assert ps[0] >= ps[1] >= ps[2] >= 1
    assert band_max_omega(cfgs[2]) > band_max_omega(cfgs[0])
    for p in ps:
        assert p & (p - 1) == 0


def test_distance_stretches_fine_bands_only():
    cfgs = _bands()
    near = periods_for_distance(cfgs, DT, camera_distance=50.0)
    far = periods_for_distance(cfgs, DT, camera_distance=800.0)
    assert near == nyquist_periods(cfgs, DT)
    # the 17 m and 130 m bands are finer than an 800 m view; they stretch
    assert far[2] >= near[2]
    assert far[1] >= near[1]
    # the 1000 m band is the distant silhouette; physics rate kept
    assert far[0] == near[0]


def test_bad_periods_rejected():
    cfgs = _bands()
    with pytest.raises(ValueError):
        LODCascadeSolver(cfgs, periods=[3, 1, 1], dt=DT)    # not pow2
    with pytest.raises(ValueError):
        LODCascadeSolver(cfgs, periods=[1, 1], dt=DT)       # wrong count
    lod = LODCascadeSolver(cfgs, periods=[1, 1, 1], dt=DT)
    st = lod.init()
    with pytest.raises(ValueError):
        lod.step(st, dt=DT * 2)                             # schedule dt fixed


def test_frame_counter_is_host_side():
    """The schedule slot must be known WITHOUT a device pull (a per-frame
    device→host sync) — frame is a plain Python int."""
    cfgs = _bands()
    lod = LODCascadeSolver(cfgs, periods=[2, 1, 1], dt=DT)
    st = lod.init()
    assert isinstance(st.frame, int)
    st, _ = lod.step(st)
    assert isinstance(st.frame, int) and st.frame == 1


def test_absolute_mode_lod_matches_plain():
    cfgs = [c.replace(evolution_mode="absolute", dispersion_mode="quantized")
            for c in _bands()]
    plain = CascadeSolver(cfgs)
    lod = LODCascadeSolver(cfgs, periods=[2, 2, 1], dt=DT)
    sp = plain.init()
    sl = lod.init()
    for f in range(1, 5):
        sp, fp = plain.step(sp, DT)
        sl, fl = lod.step(sl)
        if f % 2 == 0:
            np.testing.assert_allclose(np.asarray(fl.height),
                                       np.asarray(fp.height),
                                       rtol=0, atol=1e-4)


def test_lod_plane_cache_is_live_channels_only():
    """Stencil bands cache 3 planes per band (slopes are dead), spectral 5;
    packing changes the refresh transform, never the cache layout."""
    solver = LODCascadeSolver(_bands(), dt=DT)
    assert solver.plane_count == 3
    assert solver.init().planes.shape == (3, 3, N, N)
    packed = LODCascadeSolver(_bands(), dt=DT, pack_channels=True)
    assert packed.plane_count == 3
    assert packed.init().planes.shape == (3, 3, N, N)
    spec = [c.replace(normals_mode="spectral") for c in _bands()]
    assert LODCascadeSolver(spec, dt=DT).init().planes.shape == (3, 5, N, N)


def test_lod_packed_matches_unpacked_on_hermitized_state():
    """Packed LOD refreshes reproduce the unpacked LOD trajectory exactly
    (same hermitized h0) — held frames, refresh frames, all of it."""
    import jax
    from tpu_ocean.evolve import hermitize_pair

    periods = [4, 2, 1]
    plain = LODCascadeSolver(_bands(), periods=periods, dt=DT)
    packed = LODCascadeSolver(_bands(), periods=periods, dt=DT,
                              pack_channels=True)
    key = jax.numpy.asarray(jax.random.PRNGKey(9))
    sp = plain.init(key)
    a, ac = jax.vmap(hermitize_pair)(sp.cascade.h0, sp.cascade.h0_conj)
    cst = sp.cascade._replace(h0=a, h0_conj=ac)
    sp = sp._replace(cascade=cst,
                     planes=jax.jit(plain._planes_at)(
                         cst, plain.inner._coeffs))
    sq = packed.init(key)

    for _ in range(5):
        sp, fp = plain.step(sp)
        sq, fq = packed.step(sq)
        for name in ("height", "disp_x", "normal", "foam"):
            p = np.asarray(getattr(fp, name))
            q = np.asarray(getattr(fq, name))
            scale = max(np.abs(p).max(), 1e-6)
            # normals renormalize O(1) vectors: fusion-order noise lands
            # a shade above the raw-plane bound
            tol = 2e-5 if name == "normal" else 5e-6
            assert np.abs(p - q).max() < tol * scale, name


@pytest.mark.parametrize("pack", [False, True])
def test_lod_real_state_matches_complex(pack):
    """LOD over the all-f32 cascade state: same trajectory as the complex
    LOD (held frames, refresh frames, the lot) — the shipping cascade's
    state layout."""
    import jax
    periods = [4, 2, 1]
    cplx = LODCascadeSolver(_bands(), periods=periods, dt=DT,
                            pack_channels=pack)
    real = LODCascadeSolver(_bands(), periods=periods, dt=DT,
                            pack_channels=pack, real_state=True)
    key = jax.random.PRNGKey(11)
    sc, sr = cplx.init(key), real.init(key)
    np.testing.assert_array_equal(np.asarray(jnp.real(sc.cascade.h0)),
                                  np.asarray(sr.cascade.h0_re))
    for _ in range(5):
        sc, fc = cplx.step(sc)
        sr, fr = real.step(sr)
        for name in ("height", "disp_x", "foam"):
            p = np.asarray(getattr(fc, name))
            q = np.asarray(getattr(fr, name))
            assert np.abs(p - q).max() < 2e-5 * max(np.abs(p).max(), 1e-6), \
                name


def test_lod_expert_sharding_matches_unsharded():
    """LOD over an 'expert'-sharded cascade (mesh passthrough, VERDICT r4
    #5): same trajectory as the unsharded LOD through held and refresh
    frames, with the production switch set."""
    import jax
    from jax.sharding import Mesh
    periods = [4, 2, 1]
    mesh = Mesh(np.asarray(jax.devices()[:3]).reshape(3), ("expert",))
    kw = dict(periods=periods, dt=DT, real_state=True, pack_channels=True)
    plain = LODCascadeSolver(_bands(), **kw)
    shard = LODCascadeSolver(_bands(), mesh=mesh, **kw)
    key = jax.random.PRNGKey(13)
    sp, ss = plain.init(key), shard.init(key)
    for _ in range(5):
        sp, fp = plain.step(sp)
        ss, fs = shard.step(ss)
        for name in ("height", "disp_x", "foam"):
            p = np.asarray(getattr(fp, name))
            q = np.asarray(getattr(fs, name))
            assert np.abs(p - q).max() < 2e-5 * max(np.abs(p).max(), 1e-6), \
                name
