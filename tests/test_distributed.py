"""Distributed-path tests on a fake 8-device CPU mesh (SURVEY.md §4.3):
(a) distributed 2-D IFFT == single-device transform on the gathered array,
(b) halo-exchanged rolls == periodic jnp.roll,
(c) sharded step == unsharded step, shard-exact."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map
import pytest

from tpu_ocean.parallel import make_mesh, roll_sharded
from tpu_ocean.parallel.halo import make_roll_fn
from tpu_ocean.fft.distributed import ifft2_x_sharded
from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver
from tpu_ocean.solver_dist import DistributedOceanSolver


def _mesh():
    assert len(jax.devices()) >= 8, "conftest should fake 8 CPU devices"
    return make_mesh(shard=8)


@pytest.mark.parametrize("shift,axis", [(1, 0), (-1, 0), (1, 1), (-3, 1)])
def test_roll_sharded_matches_jnp_roll(shift, axis):
    mesh = _mesh()
    x = np.arange(32 * 24, dtype=np.float32).reshape(32, 24)
    spec = P("shard", None) if axis == 0 else P(None, "shard")

    fn = shard_map(lambda a: roll_sharded(a, shift, axis, "shard"),
                   mesh=mesh, in_specs=(spec,), out_specs=spec)
    got = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.roll(x, shift, axis))


def test_make_roll_fn_mixed_axes():
    mesh = _mesh()
    x = np.random.default_rng(0).normal(size=(16, 16, 3)).astype(np.float32)

    def body(a):
        roll = make_roll_fn("shard", sharded_axes=(1,))
        return roll(roll(a, -1, 0), 2, 1)

    fn = shard_map(body, mesh=mesh, in_specs=(P(None, "shard", None),),
                   out_specs=P(None, "shard", None))
    got = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.roll(np.roll(x, -1, 0), 2, 1))


@pytest.mark.parametrize("backend", ["reference", "stockham", "matmul"])
def test_distributed_ifft2_matches_single_device(backend):
    mesh = _mesh()
    n = 64
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(5, n, n)) + 1j * rng.normal(size=(5, n, n))
         ).astype(np.complex64)

    fn = shard_map(lambda a: ifft2_x_sharded(a, "shard", backend),
                   mesh=mesh, in_specs=(P(None, "shard", None),),
                   out_specs=P(None, None, "shard"))
    got = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    want = np.fft.ifft2(x) * n * n
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_distributed_ifft2_precision_reaches_backend(precision):
    """The precision policy reaches the distributed transform's dots
    (ADVICE r2: it was computed but dropped on the non-fused paths) —
    verified structurally in the lowered program, since CPU executes every
    tier identically: float32 lowers every dot at HIGHEST, bfloat16 casts
    the dot operands to bf16 and leaves no HIGHEST behind."""
    import re
    mesh = _mesh()
    n = 64
    x = jnp.ones((3, n, n), jnp.complex64)
    fn = shard_map(lambda a: ifft2_x_sharded(a, "shard", "matmul",
                                             precision=precision),
                   mesh=mesh, in_specs=(P(None, "shard", None),),
                   out_specs=P(None, None, "shard"))
    txt = jax.jit(fn).lower(x).as_text()
    found = set(re.findall(r'precision = \[(\w+)', txt))
    if precision == "float32":
        assert found == {"HIGHEST"}, found
        assert "bf16" not in txt
    else:
        assert "HIGHEST" not in found, found
        assert "bf16" in txt


def test_distributed_solver_bf16_precision_plumbed():
    """DistributedOceanSolver(precision='bfloat16') lowers its transform
    dots on bf16 operands, not silently at HIGHEST."""
    import re
    mesh = _mesh()
    cfg = OceanConfig(resolution=32, length=32.0, wind=(8.0, 5.0),
                      amplitude=0.5, evolution_mode="phase",
                      spectrum_layout="fft", normals_mode="stencil",
                      precision="bfloat16")
    s = DistributedOceanSolver(cfg, mesh, fft_backend="matmul")
    st = s.init(jax.random.PRNGKey(0))
    txt = s._step_jit.lower(st, jnp.float32(1 / 60), s._omega, s._coeffs,
                            s._pre_re, s._pre_im, s._post_re, s._post_im,
                            s._x0, s._z0).as_text()
    found = set(re.findall(r'precision = \[(\w+)', txt))
    assert "HIGHEST" not in found, found
    assert "bf16" in txt


@pytest.mark.parametrize("layout,normals,quirk", [
    ("centered", "spectral", True),
    ("fft", "stencil", False),
])
def test_sharded_step_matches_unsharded(layout, normals, quirk):
    """(c): the distributed step reproduces the single-device step."""
    mesh = _mesh()
    n = 64
    cfg = OceanConfig(resolution=n, length=float(n), unit_width=1.0,
                      wind=(9.0, 4.0), amplitude=0.15, choppiness=1.1,
                      dispersion_mode="quantized", evolution_mode="absolute",
                      spectrum_layout=layout, normals_mode=normals,
                      oracle_sign_quirk=quirk)
    rng = np.random.default_rng(2)
    h0 = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))

    single = OceanSolver(cfg)
    s1 = single.init(h0=h0, h0_conj=h0c)
    dist = DistributedOceanSolver(cfg, mesh)
    s8 = dist.init(h0=h0, h0_conj=h0c)

    dt = 1 / 60
    for _ in range(3):
        s1, f1 = single.step(s1, dt)
        s8, f8 = dist.step(s8, dt)

    assert float(s8.t) == float(s1.t)
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z",
                 "normal", "foam", "jacobian"):
        a = np.asarray(getattr(f1, name))
        b = np.asarray(getattr(f8, name))
        tol = 2e-6 * max(np.abs(a).max(), 1e-9)
        np.testing.assert_allclose(
            b, a, atol=tol, err_msg=f"distributed {name} != single-device")


def test_sharded_phase_mode_state_threading():
    """Phase-accumulation state stays consistent across sharded steps."""
    mesh = _mesh()
    n = 32
    cfg = OceanConfig(resolution=n, length=float(n), unit_width=1.0,
                      wind=(6.0, 3.0), amplitude=0.1, choppiness=0.5,
                      dispersion_mode="capillary", evolution_mode="phase",
                      spectrum_layout="fft", normals_mode="stencil",
                      oracle_sign_quirk=False)
    rng = np.random.default_rng(3)
    h0 = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))

    single = OceanSolver(cfg)
    dist = DistributedOceanSolver(cfg, mesh)
    s1, s8 = single.init(h0=h0, h0_conj=h0c), dist.init(h0=h0, h0_conj=h0c)
    for _ in range(5):
        s1, f1 = single.step(s1, 0.016)
        s8, f8 = dist.step(s8, 0.016)
    np.testing.assert_allclose(np.asarray(s8.phase), np.asarray(s1.phase),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(f8.height), np.asarray(f1.height),
                               atol=2e-6 * np.abs(f1.height).max())


def test_channel_sharded_ifft2_matches_single_device():
    from tpu_ocean.fft.distributed import ifft2_channel_sharded
    mesh = make_mesh(shard=4)
    rng = np.random.default_rng(3)
    n = 16
    x = (rng.standard_normal((4, n, n))
         + 1j * rng.standard_normal((4, n, n))).astype(np.complex64)

    fn = shard_map(lambda a: ifft2_channel_sharded(a, "shard"),
                   mesh=mesh, in_specs=(P("shard", None, None),),
                   out_specs=P(None, None, None), check_vma=False)
    got = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    want = np.fft.ifft2(x) * (n * n)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_sharded_step_matmul_backend_matches_single():
    """Full distributed step with the four-step matmul local transforms."""
    mesh = _mesh()
    n = 64
    cfg = OceanConfig(resolution=n, length=float(n), unit_width=1.0,
                      wind=(9.0, 4.0), amplitude=0.15, choppiness=1.1,
                      dispersion_mode="capillary", evolution_mode="phase",
                      spectrum_layout="fft", normals_mode="stencil",
                      oracle_sign_quirk=False)
    rng = np.random.default_rng(5)
    h0 = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    single = OceanSolver(cfg)
    dist = DistributedOceanSolver(cfg, mesh, fft_backend="matmul")
    s1 = single.init(h0=h0, h0_conj=h0c)
    s8 = dist.init(h0=h0, h0_conj=h0c)
    for _ in range(2):
        s1, f1 = single.step(s1, 1 / 60)
        s8, f8 = dist.step(s8, 1 / 60)
    tol = 2e-5 * np.abs(np.asarray(f1.height)).max()
    np.testing.assert_allclose(np.asarray(f8.height), np.asarray(f1.height),
                               atol=tol)
    np.testing.assert_allclose(np.asarray(f8.foam), np.asarray(f1.foam),
                               atol=1e-4)


@pytest.mark.parametrize("overlap", [1, 3])
def test_sharded_step_overlap_chunks_matches_single(overlap):
    """overlap_chunks splits the 3-channel transform batch so each chunk's
    a2a transpose can overlap the next chunk's row pass — a no-op for the
    numbers: the sharded step equals the single-device step either way."""
    mesh = _mesh()
    n = 64
    cfg = OceanConfig(resolution=n, length=float(n), unit_width=1.0,
                      wind=(9.0, 4.0), amplitude=0.15, choppiness=1.1,
                      dispersion_mode="capillary", evolution_mode="phase",
                      spectrum_layout="fft", normals_mode="stencil",
                      oracle_sign_quirk=False)
    rng = np.random.default_rng(6)
    h0 = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    single = OceanSolver(cfg)
    dist = DistributedOceanSolver(cfg, mesh, overlap_chunks=overlap)
    s1 = single.init(h0=h0, h0_conj=h0c)
    s8 = dist.init(h0=h0, h0_conj=h0c)
    for _ in range(2):
        s1, f1 = single.step(s1, 1 / 60)
        s8, f8 = dist.step(s8, 1 / 60)
    tol = 2e-5 * np.abs(np.asarray(f1.height)).max()
    np.testing.assert_allclose(np.asarray(f8.height), np.asarray(f1.height),
                               atol=tol)
    np.testing.assert_allclose(np.asarray(f8.disp_x), np.asarray(f1.disp_x),
                               atol=tol)
    np.testing.assert_allclose(np.asarray(f8.foam), np.asarray(f1.foam),
                               atol=1e-4)


def test_sharded_shipping_step_matches_single():
    """The shipping switches (solver.PRODUCTION) sharded: real state,
    packing, the mirror-balanced C2R route and the ring-halo stencils on
    Z-sharded fields == the single-device shipping step."""
    from tpu_ocean.solver import PRODUCTION
    mesh = _mesh()
    n = 64
    cfg = OceanConfig(resolution=n, length=float(n), unit_width=1.0,
                      wind=(9.0, 4.0), amplitude=0.15, choppiness=1.1,
                      dispersion_mode="capillary", evolution_mode="phase",
                      spectrum_layout="fft", normals_mode="stencil",
                      oracle_sign_quirk=False)
    rng = np.random.default_rng(7)
    h0 = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    single = OceanSolver(cfg, **PRODUCTION)
    dist = DistributedOceanSolver(cfg, mesh, **PRODUCTION)
    s1 = single.init(h0=h0, h0_conj=h0c)
    s8 = dist.init(h0=h0, h0_conj=h0c)
    for _ in range(2):
        s1, f1 = single.step(s1, 1 / 60)
        s8, f8 = dist.step(s8, 1 / 60)
    hmax = np.abs(np.asarray(f1.height)).max()
    np.testing.assert_allclose(np.asarray(f8.height), np.asarray(f1.height),
                               atol=2e-5 * hmax)
    # normal + foam exercise the boundary-column halo ring
    np.testing.assert_allclose(np.asarray(f8.normal), np.asarray(f1.normal),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(f8.foam), np.asarray(f1.foam),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(f8.jacobian),
                               np.asarray(f1.jacobian), atol=1e-4)


def test_grad_through_sharded_step_matches_single_device():
    """Adjoint inversion at scale: jax.grad flows through the shard_map
    step — the all_to_all transpose and the ppermute halo ring both have
    transpose rules — and must equal the single-device adjoint. This is the
    distributed twin of test_autodiff.test_grad_through_full_step_wrt_h0."""
    n = 64
    cfg = OceanConfig(resolution=n, length=float(n), wind=(6.0, 4.0),
                      amplitude=0.05, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")

    single = OceanSolver(cfg, fft_backend="matmul")
    base_s = single.init(jax.random.PRNGKey(0))

    def loss_single(h0):
        st = base_s._replace(h0=h0, h0_conj=jnp.conj(h0[::-1, ::-1]))
        _, f = single.step(st, 1 / 60)
        return jnp.sum(f.height ** 2) + jnp.sum(f.foam)

    dist = DistributedOceanSolver(cfg, _mesh(), fft_backend="matmul")
    base_d = dist.init(jax.random.PRNGKey(0))

    def loss_dist(h0):
        st = base_d._replace(h0=h0, h0_conj=jnp.conj(h0[::-1, ::-1]))
        st, f = dist._sharded_step(
            st, jnp.float32(1 / 60), dist._omega, dist._coeffs,
            dist._pre_re, dist._pre_im, dist._post_re, dist._post_im,
            dist._x0, dist._z0)
        return jnp.sum(f.height ** 2) + jnp.sum(f.foam)

    g_single = jax.jit(jax.grad(loss_single))(base_s.h0)
    g_dist = jax.jit(jax.grad(loss_dist))(base_d.h0)
    gs, gd = np.asarray(g_single), np.asarray(g_dist)
    assert np.isfinite(gs).all() and np.abs(gs).max() > 0
    scale = np.abs(gs).max()
    assert np.abs(gs - gd).max() < 1e-4 * scale


# --------------------------------------------------- real-state (VERDICT r3 #3)

def _fft_cfg(n, **kw):
    base = dict(resolution=n, length=float(n), unit_width=1.0,
                wind=(9.0, 4.0), amplitude=0.15, choppiness=1.1,
                dispersion_mode="capillary", evolution_mode="phase",
                spectrum_layout="fft", normals_mode="stencil",
                oracle_sign_quirk=False)
    base.update(kw)
    return OceanConfig(**base)


def _pair64(n, seed):
    rng = np.random.default_rng(seed)
    h0 = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    return h0, h0c


@pytest.mark.parametrize("pack,half,overlap", [
    (False, False, 1), (True, False, 1), (True, True, 1), (False, False, 3)])
def test_sharded_real_state_matches_complex_sharded(pack, half, overlap):
    """DistributedOceanSolver(real_state=True): the all-f32 sharded step
    reproduces the complex sharded step from the same injected h0, with and
    without packing, the half-spectrum route and overlap chunking."""
    mesh = _mesh()
    n = 64
    cfg = _fft_cfg(n)
    h0, h0c = _pair64(n, seed=7)
    kw = dict(pack_channels=pack, half_spectrum=half,
              overlap_chunks=overlap)
    cplx = DistributedOceanSolver(cfg, mesh, **kw)
    real = DistributedOceanSolver(cfg, mesh, real_state=True, **kw)
    s1 = cplx.init(h0=h0, h0_conj=h0c)
    s2 = real.init(h0=h0, h0_conj=h0c)
    from tpu_ocean.solver import OceanStateReal
    assert isinstance(s2, OceanStateReal)
    for _ in range(3):
        s1, f1 = cplx.step(s1, 1 / 60)
        s2, f2 = real.step(s2, 1 / 60)
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z",
                 "normal", "foam", "jacobian"):
        a = np.asarray(getattr(f1, name))
        b = np.asarray(getattr(f2, name))
        # normalization amplifies the f32 expansion-order delta on 'normal'
        tol = (2e-5 if name == "normal" else 5e-6) * max(np.abs(a).max(),
                                                         1e-9)
        np.testing.assert_allclose(b, a, atol=tol,
                                   err_msg=f"real-state {name} != complex")
    np.testing.assert_allclose(np.asarray(s2.phase), np.asarray(s1.phase),
                               atol=1e-6)


def test_sharded_real_state_io_is_f32():
    """The sharded real-state step and velocity programs take and return
    only f32/int32 arrays (state, fields, velocity) — checkpoints and the
    wire never see complex64; velocity is traced once per solver."""
    mesh = _mesh()
    cfg = _fft_cfg(32)
    s = DistributedOceanSolver(cfg, mesh, real_state=True)
    st = s.init(jax.random.PRNGKey(0))
    out = jax.eval_shape(s.step, st, 1 / 60)
    for leaf in jax.tree.leaves((st, out)):
        assert leaf.dtype in (jnp.float32, jnp.int32), leaf.dtype
    v = s.velocity(st)                     # triggers the cached trace
    assert v.dtype == jnp.float32 and np.isfinite(np.asarray(v)).all()
    fn = s._velocity_jit
    assert fn is not None
    _ = s.velocity(st)
    assert s._velocity_jit is fn           # cached, one trace per solver


@pytest.mark.parametrize("backend,layout,normals,quirk,real", [
    ("reference", "centered", "spectral", True, False),
    ("matmul", "fft", "stencil", False, False),
    ("stockham", "fft", "stencil", False, False),
    ("reference", "fft", "stencil", False, True),
    ("reference", "fft", "spectral", False, True),
])
def test_distributed_velocity_matches_single_device(backend, layout,
                                                    normals, quirk, real):
    """dist.velocity == single-device OceanSolver.velocity (same h0, same
    trajectory) across backends, both layouts, and both representations."""
    mesh = _mesh()
    n = 64
    cfg = OceanConfig(resolution=n, length=float(n), unit_width=1.0,
                      wind=(9.0, 4.0), amplitude=0.15, choppiness=1.1,
                      dispersion_mode="capillary", evolution_mode="phase",
                      spectrum_layout=layout, normals_mode=normals,
                      oracle_sign_quirk=quirk)
    h0, h0c = _pair64(n, seed=8)
    single = OceanSolver(cfg, fft_backend="reference")
    dist = DistributedOceanSolver(cfg, mesh, fft_backend=backend,
                                  real_state=real)
    s1 = single.init(h0=h0, h0_conj=h0c)
    s8 = dist.init(h0=h0, h0_conj=h0c)
    for _ in range(2):
        s1, _ = single.step(s1, 1 / 60)
        s8, _ = dist.step(s8, 1 / 60)
    v1 = np.asarray(single.velocity(s1))
    v8 = np.asarray(dist.velocity(s8))
    scale = max(np.abs(v1).max(), 1e-9)
    assert np.abs(v8 - v1).max() < 2e-3 * scale


def test_sharded_real_state_checkpoint_roundtrip(tmp_path):
    """Sharded real state → save_checkpoint (host npz) → load(real_state=True)
    → shard_state back onto the mesh: the resumed trajectory is bitwise the
    uninterrupted one (SURVEY §5.4 across the distributed real path)."""
    from tpu_ocean.checkpoint import save_checkpoint, load_checkpoint
    mesh = _mesh()
    n = 32
    cfg = _fft_cfg(n)
    solver = DistributedOceanSolver(cfg, mesh, real_state=True)
    st = solver.init(jax.random.PRNGKey(3))
    for _ in range(2):
        st, _ = solver.step(st, 1 / 60)
    p = save_checkpoint(str(tmp_path / "dist_real.npz"), st, cfg=cfg)
    loaded, _ = load_checkpoint(p, real_state=True)
    resumed = solver.shard_state(loaded)
    a, fa = solver.step(st, 1 / 60)
    b, fb = solver.step(resumed, 1 / 60)
    np.testing.assert_array_equal(np.asarray(fa.height),
                                  np.asarray(fb.height))
    np.testing.assert_array_equal(np.asarray(a.phase), np.asarray(b.phase))
    with pytest.raises(ValueError, match="representation"):
        cplx = DistributedOceanSolver(cfg, mesh)
        cplx.shard_state(loaded)


def test_sharded_real_state_validation():
    mesh = _mesh()
    with pytest.raises(ValueError, match="real_state"):
        DistributedOceanSolver(_fft_cfg(32), mesh, fft_backend="matmul",
                               real_state=True)
    with pytest.raises(ValueError, match="spectrum_layout"):
        DistributedOceanSolver(
            OceanConfig(resolution=32, length=32.0, unit_width=1.0,
                        wind=(9.0, 4.0), amplitude=0.15,
                        spectrum_layout="centered", normals_mode="spectral",
                        oracle_sign_quirk=True),
            mesh, real_state=True)
