"""Hermitian channel packing (evolve.packed_coefficients): pairs of real
output fields ride one complex transform — 3 live channels on 2 FFTs, 5 on 3.

Parity claim under test: on a HERMITIZED state (OceanSolver.symmetrize's
projection, applied at init when pack_channels=True) the packed step's
extracted fields equal the unpacked step's to f32 rounding; and the
projection itself changes no extracted field when the fft layout's
self-paired modes (k = 0 row/column and the Nyquist lines) carry no
asymmetric content. Reference extraction being Re/Im of full complex
transforms: FFTMesh.cs:253-276."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver
from tpu_ocean.solver_dist import DistributedOceanSolver
from tpu_ocean.parallel import make_mesh
from tpu_ocean.evolve import (
    spectrum_coefficients, packed_coefficients, hermitize_pair,
    hermitize_planes,
)

FIELDS = ("height", "disp_x", "disp_z", "pos_x", "pos_z",
          "normal", "foam", "jacobian")


def _cfg(n=64, normals="stencil", **kw):
    base = dict(resolution=n, length=float(n), unit_width=1.0,
                wind=(9.0, 4.0), amplitude=0.15, choppiness=1.1,
                dispersion_mode="quantized", evolution_mode="absolute",
                spectrum_layout="fft", normals_mode=normals,
                oracle_sign_quirk=False)
    base.update(kw)
    return OceanConfig(**base)


def _pair(n, seed=2, scale=0.05):
    rng = np.random.default_rng(seed)
    h0 = scale * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = scale * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    return h0, h0c


def _negflip_np(x):
    n = x.shape[0]
    neg = (-np.arange(n)) % n
    return x[np.ix_(neg, neg)]


def _assert_fields_close(got, want, tol_scale, foam_scale=25.0):
    for name in FIELDS:
        a = np.asarray(getattr(want, name))
        b = np.asarray(getattr(got, name))
        if name == "normal":
            # normalization amplifies f32 rounding where the slope is tiny
            # (house style: test_parity's 1e-3 band); every other field
            # stays on the tight band below
            tol = 2e-4
        else:
            scale = foam_scale if name == "foam" else 1.0
            tol = scale * tol_scale * max(np.abs(a).max(), 1e-9)
        np.testing.assert_allclose(b, a, atol=tol,
                                   err_msg=f"packed {name} != unpacked")


# ---------------------------------------------------------------- math layer

@pytest.mark.parametrize("nch", [3, 5])
def test_packed_coefficients_structure(nch):
    """[2P, N, N]; every packed plane (beyond row 0's +1 height term) is the
    ODD part of an unpacked multiplier under the index negation map — so it
    flips sign under negflip, and vanishes exactly where the multiplier's
    own k-component is self-paired: the kx Nyquist ROW for kx-built
    multipliers (r_x, −kx), the kz Nyquist COLUMN for kz-built ones
    (r_z, −kz). |k| is invariant under the map, so away from those lines
    the odd part IS the multiplier."""
    cfg = _cfg(32, normals="stencil" if nch == 3 else "spectral")
    pack = packed_coefficients(cfg, nch)
    p = 2 if nch == 3 else 3
    assert pack.shape == (2 * p, 32, 32)
    coeffs = spectrum_coefficients(cfg).real
    nyq = 16

    odd_rows = [pack[0] - 1.0] + list(pack[1:])   # strip the height +1
    for row in odd_rows:
        # odd parts are exactly antisymmetric under the index negation map
        np.testing.assert_allclose(_negflip_np(row), -row, atol=0)

    def expect(mult, axis):
        """multiplier with its self-paired Nyquist line zeroed."""
        e = mult.copy()
        if axis == 0:
            e[nyq, :] = 0.0
        else:
            e[:, nyq] = 0.0
        return e

    if nch == 3:
        np.testing.assert_allclose(pack[0] - 1.0, expect(coeffs[1], 0),
                                   atol=1e-15)            # r_x (row-masked)
        np.testing.assert_array_equal(pack[1], 0.0)
        np.testing.assert_array_equal(pack[2], 0.0)
        np.testing.assert_allclose(pack[3], expect(coeffs[2], 1),
                                   atol=1e-15)            # r_z (col-masked)
    else:
        np.testing.assert_allclose(pack[0] - 1.0, expect(coeffs[1], 0),
                                   atol=1e-15)
        np.testing.assert_allclose(pack[1], expect(coeffs[3], 0),
                                   atol=1e-15)            # −kx (row-masked)
        np.testing.assert_array_equal(pack[2], 0.0)
        np.testing.assert_array_equal(pack[3], 0.0)
        np.testing.assert_allclose(pack[4], expect(coeffs[2], 1),
                                   atol=1e-15)            # r_z (col-masked)
        np.testing.assert_allclose(pack[5], expect(coeffs[4], 1),
                                   atol=1e-15)            # −kz (col-masked)


def test_packed_coefficients_requires_fft_layout():
    cfg = _cfg(32, spectrum_layout="centered")
    with pytest.raises(ValueError):
        packed_coefficients(cfg, 3)


def test_hermitize_is_bitwise_idempotent():
    """On an already-Hermitian pair conj(h0c∘neg) == h0 exactly and
    ½(x + x) = x in fp — resume paths re-apply it unconditionally."""
    n = 32
    h0, h0c = _pair(n, seed=5)
    a, ac = hermitize_pair(jnp.asarray(h0, jnp.complex64),
                           jnp.asarray(h0c, jnp.complex64))
    a2, ac2 = hermitize_pair(a, ac)
    np.testing.assert_array_equal(np.asarray(a2), np.asarray(a))
    np.testing.assert_array_equal(np.asarray(ac2), np.asarray(ac))

    planes = hermitize_planes(
        jnp.asarray(h0.real, jnp.float32), jnp.asarray(h0.imag, jnp.float32),
        jnp.asarray(h0c.real, jnp.float32), jnp.asarray(h0c.imag, jnp.float32))
    planes2 = hermitize_planes(*planes)
    for x, y in zip(planes2, planes):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # and the two representations agree
    np.testing.assert_allclose(np.asarray(planes[0]),
                               np.asarray(a).real, atol=1e-7)
    np.testing.assert_allclose(np.asarray(planes[3]),
                               np.asarray(ac).imag, atol=1e-7)


def test_symmetrize_preserves_fields_without_selfpaired_content():
    """The projection only touches what Re/Im extraction discards: with the
    self-paired modes (k=0, Nyquist lines) zeroed, an UNPACKED solver sees
    identical fields before and after symmetrize."""
    n = 64
    cfg = _cfg(n)
    h0, h0c = _pair(n, seed=7)
    for a in (h0, h0c):
        a[0, :] = 0.0
        a[:, 0] = 0.0
        a[n // 2, :] = 0.0
        a[:, n // 2] = 0.0
    ah0, ah0c = map(np.asarray, hermitize_pair(
        jnp.asarray(h0, jnp.complex64), jnp.asarray(h0c, jnp.complex64)))

    solver = OceanSolver(cfg, fft_backend="reference")
    s_raw = solver.init(h0=h0, h0_conj=h0c)
    s_sym = solver.init(h0=ah0, h0_conj=ah0c)
    _, f_raw = solver.step(s_raw, 1 / 60)
    _, f_sym = solver.step(s_sym, 1 / 60)
    _assert_fields_close(f_sym, f_raw, 2e-6)


# ------------------------------------------------------------- solver parity

@pytest.mark.parametrize("normals,backend", [
    ("stencil", "reference"),
    ("spectral", "reference"),
    ("stencil", "matmul"),
    ("stencil", "stockham"),
])
def test_packed_step_matches_unpacked_on_hermitized_state(normals, backend):
    """The core parity claim: same hermitized h0 into a packed and an
    unpacked solver → every extracted field equal to f32 rounding."""
    n = 64
    cfg = _cfg(n, normals=normals)
    h0, h0c = _pair(n)
    ah0, ah0c = map(np.asarray, hermitize_pair(
        jnp.asarray(h0, jnp.complex64), jnp.asarray(h0c, jnp.complex64)))

    plain = OceanSolver(cfg, fft_backend=backend)
    packed = OceanSolver(cfg, fft_backend=backend, pack_channels=True)
    assert packed._pch == (2 if normals == "stencil" else 3)
    sp = plain.init(h0=ah0, h0_conj=ah0c)
    sq = packed.init(h0=h0, h0_conj=h0c)   # init symmetrizes internally

    dt = 1 / 60
    for _ in range(3):
        sp, fp = plain.step(sp, dt)
        sq, fq = packed.step(sq, dt)
    _assert_fields_close(fq, fp, 5e-6)


@pytest.mark.parametrize("normals", ["stencil", "spectral"])
def test_packed_matmul_matches_reference_packed(normals):
    """The four-step matmul backend (f32 dots at HIGHEST) transforms the
    packed channels to the jnp.fft result's f32 rounding."""
    n = 64
    cfg = _cfg(n, normals=normals, evolution_mode="phase",
               dispersion_mode="capillary")
    key = jax.random.PRNGKey(11)
    ref = OceanSolver(cfg, fft_backend="reference", pack_channels=True)
    fus = OceanSolver(cfg, fft_backend="matmul", pack_channels=True)
    s1, s2 = ref.init(key), fus.init(key)
    for _ in range(2):
        s1, f1 = ref.step(s1, 1 / 60)
        s2, f2 = fus.step(s2, 1 / 60)
    _assert_fields_close(f2, f1, 5e-6)


def test_packed_real_state_matches_complex_state():
    """real_state=True (the shipping configuration) packs through the
    all-f32 plane path — hermitize_planes at init, plane assembly in step."""
    n = 64
    cfg = _cfg(n, evolution_mode="phase", dispersion_mode="capillary")
    h0, h0c = _pair(n, seed=3)
    cplx = OceanSolver(cfg, pack_channels=True)
    real = OceanSolver(cfg, pack_channels=True, real_state=True)
    s1 = cplx.init(h0=h0, h0_conj=h0c)
    s2 = real.init(h0=jnp.asarray(h0, jnp.complex64),
                   h0_conj=jnp.asarray(h0c, jnp.complex64))
    for _ in range(2):
        s1, f1 = cplx.step(s1, 1 / 60)
        s2, f2 = real.step(s2, 1 / 60)
    _assert_fields_close(f2, f1, 5e-6)


def test_pack_channels_validation():
    with pytest.raises(ValueError, match="pack_channels"):
        OceanSolver(_cfg(32, spectrum_layout="centered",
                         normals_mode="spectral", oracle_sign_quirk=True),
                    pack_channels=True)
    with pytest.raises(ValueError):
        DistributedOceanSolver(
            _cfg(32, spectrum_layout="centered", normals_mode="spectral",
                 oracle_sign_quirk=True),
            make_mesh(shard=8), pack_channels=True)


# -------------------------------------------------------------- distributed

@pytest.mark.parametrize("backend,real", [("reference", False),
                                          ("reference", True),
                                          ("matmul", False)])
def test_distributed_packed_matches_single_device(backend, real):
    """Sharded packed step == single-device packed step (both state
    layouts); packing also cuts the all_to_all transpose volume to P/nch
    of the unpacked step's."""
    mesh = make_mesh(shard=8)
    n = 64
    cfg = _cfg(n)
    h0, h0c = _pair(n)

    single = OceanSolver(cfg, fft_backend=backend, pack_channels=True,
                         real_state=real)
    dist = DistributedOceanSolver(cfg, mesh, fft_backend=backend,
                                  pack_channels=True, real_state=real)
    assert dist._pch == 2
    s1 = single.init(h0=h0, h0_conj=h0c)
    s8 = dist.init(h0=h0, h0_conj=h0c)

    dt = 1 / 60
    for _ in range(3):
        s1, f1 = single.step(s1, dt)
        s8, f8 = dist.step(s8, dt)
    _assert_fields_close(f8, f1, 5e-6)


def test_distributed_packed_overlap_chunks():
    """overlap_chunks must divide the PACKED transform batch (2, not 3)."""
    mesh = make_mesh(shard=8)
    cfg = _cfg(64)
    with pytest.raises(ValueError, match="overlap_chunks"):
        DistributedOceanSolver(cfg, mesh, pack_channels=True,
                               overlap_chunks=3)
    h0, h0c = _pair(64)
    plain = DistributedOceanSolver(cfg, mesh, pack_channels=True)
    chunked = DistributedOceanSolver(cfg, mesh, pack_channels=True,
                                     overlap_chunks=2)
    s1, s2 = plain.init(h0=h0, h0_conj=h0c), chunked.init(h0=h0, h0_conj=h0c)
    s1, f1 = plain.step(s1, 1 / 60)
    s2, f2 = chunked.step(s2, 1 / 60)
    _assert_fields_close(f2, f1, 2e-6)


# ------------------------------------------------------------------ runtime

def test_simulation_passthrough_and_resume_symmetrizes(tmp_path):
    """Simulation forwards pack_channels to the solver; auto-resume applies
    symmetrize to the restored state (bitwise no-op on packed-written
    checkpoints, Hermitian projection on pre-packing ones)."""
    from tpu_ocean import Simulation
    out = str(tmp_path / "run")
    cfg = _cfg(32, evolution_mode="phase", dispersion_mode="capillary")
    sim1 = Simulation(cfg, fft_backend="reference", pack_channels=True,
                      out_dir=out, checkpoint_every=2)
    assert sim1.solver.pack_channels
    sim1.run(4)
    sim1.close()

    sim2 = Simulation(cfg, fft_backend="reference", pack_channels=True,
                      out_dir=out, checkpoint_every=2)
    assert sim2.step_count == 4
    h0 = np.asarray(sim2.state.h0)
    h0c = np.asarray(sim2.state.h0_conj)
    np.testing.assert_array_equal(np.conj(_negflip_np(h0c)), h0)
    f = sim2.run(2)
    assert np.all(np.isfinite(np.asarray(f.height)))
    sim2.close()
