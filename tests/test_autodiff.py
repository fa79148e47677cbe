"""Differentiability — a capability the reference architecture cannot have.

The whole step is pure JAX, so gradients flow end-to-end: ∂(field loss)/∂h0,
∂/∂(wave-bank parameters), etc. This enables adjoint-style inversion (fit a
sea state to observations), which the shader pipeline structurally cannot do.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpu_ocean.config import OceanConfig, PondConfig
from tpu_ocean.solver import OceanSolver
from tpu_ocean.gerstner import WaveBank, gerstner_eval
from tpu_ocean import grids


def _cfg(n=32):
    return OceanConfig(resolution=n, length=float(n), wind=(6.0, 4.0),
                       amplitude=0.05, evolution_mode="phase",
                       dispersion_mode="capillary", spectrum_layout="fft",
                       normals_mode="stencil")


def test_grad_through_full_step_wrt_h0():
    cfg = _cfg()
    solver = OceanSolver(cfg)
    base = solver.init(jax.random.PRNGKey(0))

    def loss(h0):
        st = base._replace(h0=h0, h0_conj=jnp.conj(h0[::-1, ::-1]))
        st, f = solver._step_impl(st, jnp.float32(1 / 60))
        return jnp.sum(f.height ** 2) + jnp.sum(f.foam)

    g = jax.grad(loss)(base.h0)
    ga = np.asarray(jnp.abs(g))
    assert np.all(np.isfinite(ga)) and ga.max() > 0

    # finite-difference check on the dominant element
    idx = np.unravel_index(np.argmax(ga), ga.shape)
    eps = 1e-3
    e = jnp.zeros_like(base.h0).at[idx].set(eps)
    fd = (loss(base.h0 + e) - loss(base.h0 - e)) / (2 * eps)
    an = jnp.real(g[idx])   # grad convention: d/d(re) for real loss
    np.testing.assert_allclose(float(fd), float(an), rtol=2e-2)


def test_grad_through_gerstner_wrt_amplitudes():
    bank = WaveBank.random(3, 8)
    x, z = grids.coordinate_grid(32, 1.0)
    x = jnp.asarray(np.asarray(x, np.float32))
    z = jnp.asarray(np.asarray(z, np.float32))

    def loss(amps):
        b = WaveBank(amps=tuple(), steeps=bank.steeps, dirs_x=bank.dirs_x,
                     dirs_z=bank.dirs_z, freqs=bank.freqs, omegas=bank.omegas)
        # bypass the tuple container: evaluate with traced amp array
        arrs = bank.as_arrays()
        phase = (jnp.asarray(arrs["freqs"])
                 * (x[..., None] * jnp.asarray(arrs["dirs_x"])
                    + z[..., None] * jnp.asarray(arrs["dirs_z"]))
                 + jnp.asarray(arrs["omegas"]) * 1.3)
        h = jnp.sum(amps * jnp.sin(phase), axis=-1)
        return jnp.mean(h ** 2)

    amps0 = jnp.asarray(np.asarray(bank.amps, np.float32))
    g = jax.grad(loss)(amps0)
    assert np.all(np.isfinite(np.asarray(g))) and float(jnp.abs(g).max()) > 0


def test_jvp_linearity_of_transform():
    """The spectrum→fields map is linear in h0 at fixed phase: JVP must equal
    the primal difference exactly (up to fp32)."""
    cfg = _cfg(16)
    solver = OceanSolver(cfg)
    st = solver.init(jax.random.PRNGKey(1))

    def height_of(h0):
        s = st._replace(h0=h0)
        _, f = solver._step_impl(s, jnp.float32(1 / 60))
        return f.height

    v = jax.random.normal(jax.random.PRNGKey(2), st.h0.shape) * (1 + 0.5j)
    v = v.astype(st.h0.dtype)
    _, jvp = jax.jvp(height_of, (st.h0,), (v,))
    direct = height_of(st.h0 + v) - height_of(st.h0)
    np.testing.assert_allclose(np.asarray(jvp), np.asarray(direct),
                               atol=2e-2, rtol=1e-3)


def test_grad_through_cascade_wrt_band_h0():
    """Gradients flow through the multi-band (EP-analogue) step — per-band
    adjoint sea-state inversion over the combined surface, including the
    Σ-combine and the LOD-shared extraction path. Finite-difference checked
    on the dominant band element."""
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    cfgs = default_cascade(n=32, lengths=(100.0, 13.0))
    solver = CascadeSolver(cfgs, fft_backend="reference")
    base = solver.init(jax.random.PRNGKey(1))

    def loss(h0):
        st = base._replace(h0=h0,
                           h0_conj=jnp.conj(h0[:, ::-1, ::-1]))
        st, f = solver._step_impl(st, jnp.float32(1 / 60))
        return jnp.sum(f.height ** 2) + jnp.sum(f.foam)

    g = jax.grad(loss)(base.h0)
    ga = np.asarray(jnp.abs(g))
    assert np.all(np.isfinite(ga)) and ga.max() > 0
    assert all(ga[b].max() > 0 for b in range(ga.shape[0]))  # every band live

    idx = np.unravel_index(np.argmax(ga), ga.shape)
    eps = 1e-3
    e = jnp.zeros_like(base.h0).at[idx].set(eps)
    fd = (loss(base.h0 + e) - loss(base.h0 - e)) / (2 * eps)
    np.testing.assert_allclose(float(fd), float(jnp.real(g[idx])), rtol=2e-2)


# ---- the SHIPPING switch set is differentiable (VERDICT r4 #4) ----
# jnp.fft carries its own transpose rules (ifft2 ↔ fft2, irfft2's adjoint),
# so jax.grad runs through the headline pipeline itself.

def _mirror(p):
    """Conjugate-partner plane layout for fft ordering: p[(N−i)%N, (N−j)%N]."""
    return jnp.roll(jnp.flip(p, (0, 1)), (1, 1), (0, 1))


def _shipping_solver(n=64, **overrides):
    cfg = OceanConfig(resolution=n, length=float(n), wind=(6.0, 4.0),
                      amplitude=0.05, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    from tpu_ocean.solver import PRODUCTION
    kw = dict(PRODUCTION)
    kw.update(overrides)
    return OceanSolver(cfg, **kw)


def test_grad_through_shipping_config_finite_difference():
    """d(loss)/d(h0_re) through real_state + packed + half on jnp.fft —
    the exact bench.py headline pipeline — against a central finite
    difference on the dominant element."""
    solver = _shipping_solver()
    st = solver.init(jax.random.PRNGKey(0))

    def loss(h0_re):
        s = st._replace(h0_re=h0_re)
        _, f = solver._step_impl(s, jnp.float32(1 / 60), solver._consts)
        return jnp.sum(f.height ** 2) + jnp.sum(f.foam)

    g = jax.grad(loss)(st.h0_re)
    ga = np.asarray(jnp.abs(g))
    assert np.all(np.isfinite(ga)) and ga.max() > 0
    idx = np.unravel_index(np.argmax(ga), ga.shape)
    eps = 1e-3
    e = jnp.zeros_like(st.h0_re).at[idx].set(eps)
    fd = (loss(st.h0_re + e) - loss(st.h0_re - e)) / (2 * eps)
    np.testing.assert_allclose(float(fd), float(g[idx]), rtol=1e-2)


def test_grad_parity_packed_half_vs_unpacked():
    """Under the Hermitian-preserving parameterization (perturb h0, derive
    the conjugate partner — the inversion use case), the packed+half
    route's gradients must equal the unpacked backend's to fp tolerance:
    both compute the identical loss surface. (Grads wrt h0 ALONE may
    legitimately differ — the two routes extend non-Hermitian
    perturbations differently.)"""
    def make_loss(solver, st):
        def loss(planes):
            h0_re, h0_im = planes
            s = st._replace(h0_re=h0_re, h0_im=h0_im,
                            h0c_re=_mirror(h0_re), h0c_im=-_mirror(h0_im))
            _, f = solver._step_impl(s, jnp.float32(1 / 60), solver._consts)
            return (jnp.sum(f.height ** 2) + jnp.sum(f.foam)
                    + jnp.sum(f.normal[..., 0] ** 2))
        return loss

    ref = _shipping_solver(pack_channels=False, half_spectrum=False)
    got = _shipping_solver()
    st_r = ref.init(jax.random.PRNGKey(0))
    st_g = got.init(jax.random.PRNGKey(0))
    planes = (st_r.h0_re, st_r.h0_im)
    g_ref = jax.grad(make_loss(ref, st_r))(planes)
    g_got = jax.grad(make_loss(got, st_g))(planes)
    for a, b in zip(g_got, g_ref):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, atol=np.abs(b).max() * 1e-5)


@pytest.mark.parametrize("kind", ["full", "half"])
def test_fft_kernel_vjp_is_adjoint(kind):
    """Dot-product identity ⟨F(x), y⟩ = ⟨x, Fᵀ(y)⟩ for the VJPs of the
    plane transforms of fft.reference (full ifft2_planes and the C2R
    ifft2_planes_half) — the rule that makes the shipping pipeline
    differentiable must be the TRUE adjoint of what the transform
    computes."""
    from tpu_ocean.fft.reference import ifft2_planes, ifft2_planes_half
    c, n = 2, 64
    rows = n // 2 + 1 if kind == "half" else n
    rng = np.random.default_rng(5)
    xr = jnp.asarray(rng.standard_normal((c, rows, n)), jnp.float32)
    xi = jnp.asarray(rng.standard_normal((c, rows, n)), jnp.float32)
    f = ifft2_planes_half if kind == "half" else ifft2_planes
    y, pull = jax.vjp(f, xr, xi)
    ct = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), y)
    gr, gi = pull(ct)

    # the two inner products cancel to ~1e-4 of their term magnitudes:
    # accumulate in f64 on host so fp32 summation noise doesn't mask the
    # identity under test
    def dot64(a, b):
        return float(np.asarray(a, np.float64).ravel()
                     @ np.asarray(b, np.float64).ravel())

    lhs = sum(dot64(a, b) for a, b in zip(jax.tree.leaves(y),
                                          jax.tree.leaves(ct)))
    rhs = dot64(xr, gr) + dot64(xi, gi)
    scale = max(abs(lhs), abs(dot64(xr, gr)), 1.0)
    np.testing.assert_allclose(lhs, rhs, atol=2e-5 * scale, rtol=2e-5)


def test_fields_stencil_grad_matches_finite_difference():
    """The normals/whitecap stencils (fields.py — the only fields path now)
    differentiate through their periodic rolls: a random directional
    derivative of a loss on all three outputs matches central differences."""
    from tpu_ocean import fields as field_ops
    n = 32
    rng = np.random.default_rng(7)
    dx, h, dz = (jnp.asarray(rng.standard_normal((n, n)) * 0.1, jnp.float32)
                 for _ in range(3))

    def loss(a, b, c):
        nrm = field_ops.normals_stencil(a, b, c, 0.5)
        foam, jac = field_ops.whitecap_gpu(a, c, nrm)
        return (jnp.sum(nrm[..., 0] ** 2) + jnp.sum(foam)
                + jnp.sum(jac ** 2))

    g = jax.grad(loss, argnums=(0, 1, 2))(dx, h, dz)
    v = [jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
         for _ in range(3)]
    eps = 1e-3
    plus = loss(*(x + eps * d for x, d in zip((dx, h, dz), v)))
    minus = loss(*(x - eps * d for x, d in zip((dx, h, dz), v)))
    fd = float(plus - minus) / (2 * eps)
    an = sum(float(jnp.vdot(a, d)) for a, d in zip(g, v))
    np.testing.assert_allclose(fd, an, rtol=2e-2)
