"""Beyond-reference switches × the production pipeline.

Each beyond-reference switch (docs/parity.md ledger) is parity-tested in
isolation elsewhere; these pin the COMPOSITIONS a production deployment
actually runs — JONSWAP seas and persistent foam on the full headline
switch set (solver.PRODUCTION: real_state + pack_channels + half_spectrum
on jnp.fft), and bf16 fast mode on the packed matmul backend. One shared
h0 pair is injected into both
sides of every comparison (CLAUDE.md: never compare across independently
drawn RNG streams)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver, PRODUCTION
from test_packing import _pair


def _cfg(n=64, **kw):
    base = dict(resolution=n, length=float(n), wind=(8.0, 5.0),
                amplitude=0.5, evolution_mode="phase",
                dispersion_mode="capillary", spectrum_layout="fft",
                normals_mode="stencil")
    base.update(kw)
    return OceanConfig(**base)


_PROD = PRODUCTION


def _run(solver, st, steps=4, dt=1 / 60):
    for _ in range(steps):
        st, f = solver.step(st, dt)
    return f


def _hermitian_pair(n, seed=2):
    """Injected pair with h0c = conj(h0 ∘ neg): packed and unpacked
    solvers then evolve the IDENTICAL state (symmetrize is the identity
    on it), so any divergence is a pipeline bug, not the documented
    Hermitian-projection deviation on self-paired modes."""
    h0, _ = _pair(n, seed=seed)
    neg = (-np.arange(n)) % n
    h0c = np.conj(h0[np.ix_(neg, neg)])
    return h0, h0c


@pytest.mark.parametrize("extra", [
    {"foam_decay": 0.7},
    {"spectrum_model": "jonswap", "jonswap_fetch": 2e5},
    {"foam_decay": 0.5, "spectrum_model": "jonswap", "jonswap_fetch": 2e5},
])
def test_switch_composes_with_production_pipeline(extra):
    """foam_decay / JONSWAP on the production switch set == the same
    switches on the unpacked backend, from one injected h0 pair."""
    cfg = _cfg(**extra)
    h0, h0c = _hermitian_pair(cfg.resolution)
    ref = OceanSolver(cfg, real_state=True)
    got = OceanSolver(cfg, **_PROD)
    # hermitize BOTH (the packed route projects at init; parity needs the
    # unpacked side on the same projected state — docs/parity.md packing
    # caveat)
    sr = ref.symmetrize(ref.init(h0=h0, h0_conj=h0c))
    sg = got.symmetrize(got.init(h0=h0, h0_conj=h0c))
    fr = _run(ref, sr)
    fg = _run(got, sg)
    for name in ("height", "disp_x", "foam", "jacobian"):
        a, b = np.asarray(getattr(fg, name)), np.asarray(getattr(fr, name))
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, atol=5e-5 * scale, err_msg=name)
    if extra.get("foam_decay"):
        # the persistent-foam accumulator must actually be live
        assert float(np.asarray(fg.foam).max()) > 0


def test_bfloat16_on_production_pipeline():
    """Opt-in fast mode on the packed matmul backend (the backend whose dots
    it tiers): finite fields tracking the f32 step to the documented ~1e-2
    envelope at a few steps, and really different — the bf16 operand cast
    is explicit, so it truncates on every device, the CPU included."""
    h0, h0c = _hermitian_pair(64)
    kw = dict(fft_backend="matmul", pack_channels=True)
    f32 = OceanSolver(_cfg(), **kw)
    b16 = OceanSolver(_cfg(precision="bfloat16"), **kw)
    s32 = f32.symmetrize(f32.init(h0=h0, h0_conj=h0c))
    s16 = b16.symmetrize(b16.init(h0=h0, h0_conj=h0c))
    a = _run(f32, s32, steps=3)
    b = _run(b16, s16, steps=3)
    ha, hb = np.asarray(a.height), np.asarray(b.height)
    assert np.isfinite(hb).all()
    scale = np.abs(ha).max()
    assert np.abs(ha - hb).max() < 3e-2 * scale
    assert np.abs(ha - hb).max() > 1e-5 * scale


def test_reconfigure_preserves_production_switches():
    """Live parameter change (OceanRenderer.cs:98-109 behavior) on the
    production pipeline keeps every switch and the phase state."""
    solver = OceanSolver(_cfg(), **_PROD)
    st = solver.init(jax.random.PRNGKey(0))
    st, _ = solver.step(st, 1 / 60)
    new_cfg = solver.cfg.replace(amplitude=0.9)
    solver2, st2 = solver.reconfigure(st, new_cfg)
    assert solver2.pack_channels and solver2.half_spectrum
    assert solver2.real_state
    np.testing.assert_array_equal(np.asarray(st2.phase),
                                  np.asarray(st.phase))   # NOT reset
    st3, f = solver2.step(st2, 1 / 60)
    assert np.isfinite(np.asarray(f.height)).all()
