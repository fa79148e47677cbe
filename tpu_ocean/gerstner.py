"""Gerstner / sinusoid wave-bank pond solver (components C13/C14).

The reference evaluates trochoidal wave superpositions per vertex in the pond
vertex shader (MistralWaterLib.cginc):

* ``Gerstner`` (:71-99) — 4 waves packed into two half4 direction vectors:
    phase_w  = frequency · dot(dir_w, p.xz) + speed_w · t
    offs.x   = Σ steepness·amplitude·dir_w.x · cos(phase_w)
    offs.z   = Σ steepness·amplitude·dir_w.y · cos(phase_w)
    offs.y   = amplitude · Σ sin(phase_w)
  The computed normal is overwritten with (0,1,0) (:98) — a reference quirk
  kept behind ``normal_mode='flat'``.
* ``GerstnerLevelOne`` (:101-125) — 5 hard-coded waves with per-wave
  amp/steep/speed/dir/freq factors multiplying the global parameters.
* ``Wave`` (:127-152) — a sinusoid sheet y = A(sin(st + x f) − cos(st + z f))
  with a finite-difference normal from two offset taps (+0.05 in x and z) and
  a smoothing blend.

Here the wave bank is a first-class array-of-waves (baseline config 3 runs 16),
evaluated as one per-grid-point computation that XLA fuses into a single
loop over the N² points.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from tpu_ocean.config import PondConfig
from tpu_ocean import grids


@dataclasses.dataclass(frozen=True)
class WaveBank:
    """W superposed trochoidal waves. All fields are length-W tuples so the
    bank is hashable (usable as a static jit argument)."""

    amps: tuple          # vertical amplitude a_w
    steeps: tuple        # horizontal (choppiness) factor s_w
    dirs_x: tuple        # direction x (NOT normalized — the reference never does)
    dirs_z: tuple
    freqs: tuple         # spatial frequency f_w
    omegas: tuple        # temporal frequency ω_w (phase = f·dot(d,p) + ω·t)

    def __len__(self):
        return len(self.amps)

    def as_arrays(self, dtype=np.float32):
        return {k: np.asarray(getattr(self, k), dtype=dtype)
                for k in ("amps", "steeps", "dirs_x", "dirs_z", "freqs", "omegas")}

    # -- constructors matching the reference variants -----------------------

    @staticmethod
    def from_packed4(cfg: PondConfig) -> "WaveBank":
        """The packed-4 Gerstner bank (MistralWaterLib.cginc:71-99): shared
        amplitude/frequency/steepness, per-wave direction (AB.xy, AB.zw,
        CD.xy, CD.zw) and speed; ω_w = speed_w (t4 = _Time·speed, :81)."""
        a = cfg.amplitude * cfg.amplitude_scale   # call site ·0.01 (:172)
        ab, cd = cfg.w_direction_ab, cfg.w_direction_cd
        dirs = [(ab[0], ab[1]), (ab[2], ab[3]), (cd[0], cd[1]), (cd[2], cd[3])]
        return WaveBank(
            amps=(a,) * 4,
            steeps=(cfg.steepness,) * 4,
            dirs_x=tuple(d[0] for d in dirs),
            dirs_z=tuple(d[1] for d in dirs),
            freqs=(cfg.frequency,) * 4,
            omegas=tuple(cfg.w_speed),
        )

    @staticmethod
    def level_one(cfg: PondConfig) -> "WaveBank":
        """The 5-wave hard-coded bank (MistralWaterLib.cginc:105-109):
        per-wave factors multiply the global parameters; ω_w = speed_w·f_w."""
        amps = (0.7, 0.6, 0.6, 0.7, 0.9)
        steeps = (0.95, 0.615, 0.821, 0.462, 0.611)
        speeds = (-2.112, 0.6124, -0.878, -3.6234, 1.0)
        dirs = ((1, -0.2), (-0.9, 1), (0.2, 0.2), (-1.0, 0.77), (0.99, -1.145))
        fs = (0.954, 1.52, 0.44, 0.21, 0.8)
        a = cfg.amplitude * cfg.amplitude_scale
        freqs = tuple(cfg.frequency * f for f in fs)
        return WaveBank(
            amps=tuple(a * x for x in amps),
            steeps=tuple(cfg.steepness * s for s in steeps),
            dirs_x=tuple(d[0] for d in dirs),
            dirs_z=tuple(d[1] for d in dirs),
            freqs=freqs,
            omegas=tuple(s * f for s, f in zip(speeds, freqs)),
        )

    @staticmethod
    def random(seed: int, num_waves: int, amplitude: float = 0.1,
               freq_range=(0.1, 2.0), speed_range=(0.5, 3.0),
               steepness: float = 0.8) -> "WaveBank":
        """A reproducible W-wave bank (BASELINE config 3 uses W=16)."""
        rng = np.random.default_rng(seed)
        theta = rng.uniform(0, 2 * np.pi, num_waves)
        freqs = rng.uniform(*freq_range, num_waves)
        # amplitude ∝ 1/frequency keeps the superposition non-self-intersecting
        amps = amplitude / np.maximum(freqs, 1e-3)
        omegas = rng.uniform(*speed_range, num_waves) * freqs
        return WaveBank(
            amps=tuple(amps.tolist()),
            steeps=(steepness / num_waves,) * num_waves,
            dirs_x=tuple(np.cos(theta).tolist()),
            dirs_z=tuple(np.sin(theta).tolist()),
            freqs=tuple(freqs.tolist()),
            omegas=tuple(omegas.tolist()),
        )


class PondFields(NamedTuple):
    offset_x: jax.Array
    offset_y: jax.Array      # height
    offset_z: jax.Array
    normal: jax.Array        # [N, N, 3]

    # serving aliases: the pond family streams through the same wire names
    # as the ocean (serve.STREAMABLE), so one client consumes either.
    # SIGN: the ocean wire convention is displaced_x = x − chop·disp_x
    # (FFTMesh.cs:245, sample.surface_at), while the pond shader ADDS its
    # offsets (MistralWaterLib.cginc Displacement: vertex.xyz += offs) —
    # so the aliases NEGATE the offsets, making x − disp_x == x + offset_x
    # for every consumer applying the shared rule (review finding, r5;
    # offset_x/offset_z keep the raw shader-convention values)
    @property
    def height(self):
        return self.offset_y

    @property
    def disp_x(self):
        return -self.offset_x

    @property
    def disp_z(self):
        return -self.offset_z


def gerstner_eval(bank: WaveBank, x, z, t, normal_mode: str = "analytic"):
    """Evaluate the wave bank at positions (x, z), time t. Pure jnp; fuses
    into one VPU pass under jit.

    normal_mode:
      * 'flat'     — reference parity: normal forced to (0,1,0)
                     (MistralWaterLib.cginc:98,121).
      * 'analytic' — exact trochoidal normal
                     n = (−Σ d_x f a cos, 1 − Σ s f a sin, −Σ d_z f a cos).
    """
    arrs = bank.as_arrays()
    amps = jnp.asarray(arrs["amps"])
    steeps = jnp.asarray(arrs["steeps"])
    dx = jnp.asarray(arrs["dirs_x"])
    dz = jnp.asarray(arrs["dirs_z"])
    freqs = jnp.asarray(arrs["freqs"])
    omegas = jnp.asarray(arrs["omegas"])

    # [..., W] phase per point per wave
    phase = (freqs * (x[..., None] * dx + z[..., None] * dz)
             + omegas * jnp.asarray(t, dtype=x.dtype))
    c = jnp.cos(phase)
    s = jnp.sin(phase)

    off_x = jnp.sum(steeps * amps * dx * c, axis=-1)
    off_z = jnp.sum(steeps * amps * dz * c, axis=-1)
    off_y = jnp.sum(amps * s, axis=-1)

    if normal_mode == "flat":
        n = jnp.stack([jnp.zeros_like(off_y), jnp.ones_like(off_y),
                       jnp.zeros_like(off_y)], axis=-1)
    elif normal_mode == "analytic":
        nx = -jnp.sum(dx * freqs * amps * c, axis=-1)
        nz = -jnp.sum(dz * freqs * amps * c, axis=-1)
        ny = 1.0 - jnp.sum(steeps * freqs * amps * s, axis=-1)
        n = jnp.stack([nx, ny, nz], axis=-1)
        n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    else:
        raise ValueError(f"bad normal_mode {normal_mode!r}")
    return PondFields(off_x, off_y, off_z, n)


def sinusoid_eval(cfg: PondConfig, x, z, t):
    """The _DISPLACEMENTMODE_WAVE sheet (MistralWaterLib.cginc:127-152).

    y(p) = A·sin(s·t + p.x·f) − A·cos(s·t + p.z·f), A = amplitude·0.01 (:134);
    normal from two finite-difference taps at +0.05 in x and z (:130-131) with
    the smoothing blend (:144-145): dy ← dy·smoothing before the cross product
    cross(v2−v0, v1−v0) (:147).
    """
    a = cfg.amplitude * 0.01
    f = cfg.frequency
    st = cfg.speed * t

    def height(px, pz):
        return jnp.sin(st + px * f) * a - jnp.cos(st + pz * f) * a

    y0 = height(x, z)
    eps = 0.05
    y1 = height(x + eps, z)       # v1 = v0 + (0.05, 0, 0)
    y2 = height(x, z + eps)       # v2 = v0 + (0, 0, 0.05)
    dy1 = (y1 - y0) * cfg.smoothing
    dy2 = (y2 - y0) * cfg.smoothing
    # v2−v0 = (0, dy2, eps); v1−v0 = (eps, dy1, 0); n = cross(v2−v0, v1−v0)
    nx = -eps * dy1
    ny = jnp.full_like(y0, eps * eps)
    nz = -eps * dy2
    n = jnp.stack([nx, ny, nz], axis=-1)
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    zeros = jnp.zeros_like(y0)
    return PondFields(zeros, y0, zeros, n)


def gerstner_velocity(bank: WaveBank, x, z, t):
    """Analytic vertical surface velocity ∂y/∂t of the Gerstner bank:

        y(p, t) = Σ a_w sin(f_w·dot(d_w, p) + ω_w t)
        ∂y/∂t   = Σ a_w ω_w cos(f_w·dot(d_w, p) + ω_w t)

    The pond twin of OceanSolver.velocity (iω-weighted spectrum) — closed
    form, no finite differencing; what spray/Doppler/FSI consumers read
    (MistralWaterLib.cginc:71-99 is the evaluated bank)."""
    arrs = bank.as_arrays()
    amps = jnp.asarray(arrs["amps"])
    dx = jnp.asarray(arrs["dirs_x"])
    dz = jnp.asarray(arrs["dirs_z"])
    freqs = jnp.asarray(arrs["freqs"])
    omegas = jnp.asarray(arrs["omegas"])
    phase = (freqs * (x[..., None] * dx + z[..., None] * dz)
             + omegas * jnp.asarray(t, dtype=x.dtype))
    return jnp.sum(amps * omegas * jnp.cos(phase), axis=-1)


def sinusoid_velocity(cfg: PondConfig, x, z, t):
    """∂y/∂t of the _DISPLACEMENTMODE_WAVE sheet (MistralWaterLib.cginc:134):
    y = A·sin(s·t + x·f) − A·cos(s·t + z·f)
    ⇒ ∂y/∂t = A·s·(cos(s·t + x·f) + sin(s·t + z·f))."""
    a = cfg.amplitude * 0.01
    st = cfg.speed * jnp.asarray(t, dtype=x.dtype)
    return a * cfg.speed * (jnp.cos(st + x * cfg.frequency)
                            + jnp.sin(st + z * cfg.frequency))


class PondSolver:
    """Pond solver over a regular grid (the array stand-in for the
    per-vertex shader evaluation; baseline config 3: 512², 16 waves)."""

    def __init__(self, cfg: PondConfig, bank: Optional[WaveBank] = None,
                 normal_mode: str = "analytic"):
        self.cfg = cfg
        if bank is None and cfg.displacement_mode == "gerstner":
            bank = WaveBank.from_packed4(cfg)
        self.bank = bank
        self.normal_mode = normal_mode
        x, z = grids.coordinate_grid(cfg.resolution, cfg.unit_width)
        # host numpy grids, closed over by the jitted evaluators
        self._x = np.asarray(x, dtype=np.float32)
        self._z = np.asarray(z, dtype=np.float32)
        self._eval = jax.jit(self._eval_impl)
        self._velocity_jit = jax.jit(self._velocity_impl)

    def _eval_impl(self, t):
        mode = self.cfg.displacement_mode
        if mode == "gerstner":
            return gerstner_eval(self.bank, self._x, self._z, t,
                                 self.normal_mode)
        if mode == "wave":
            return sinusoid_eval(self.cfg, self._x, self._z, t)
        # 'off' — flat rest surface
        zeros = jnp.zeros_like(self._x)
        flat = jnp.stack([zeros, jnp.ones_like(zeros), zeros], axis=-1)
        return PondFields(zeros, zeros, zeros, flat)

    def fields(self, t: float) -> PondFields:
        return self._eval(jnp.asarray(t, dtype=jnp.float32))

    def _velocity_impl(self, t):
        mode = self.cfg.displacement_mode
        if mode == "gerstner":
            return gerstner_velocity(self.bank, jnp.asarray(self._x),
                                     jnp.asarray(self._z), t)
        if mode == "wave":
            return sinusoid_velocity(self.cfg, jnp.asarray(self._x),
                                     jnp.asarray(self._z), t)
        return jnp.zeros_like(jnp.asarray(self._x))

    def velocity(self, t) -> jax.Array:
        """Vertical surface velocity ∂h/∂t [N, N] at time ``t`` — analytic
        for both wave families (gerstner_velocity / sinusoid_velocity).
        The pond is stateless in t, so the 'state' a serving runtime holds
        IS the clock: runtime.PondSimulation passes its t here, making the
        call signature line up with OceanSolver.velocity(state) on the
        serving path (serve.FrameServer)."""
        return self._velocity_jit(jnp.asarray(t, dtype=jnp.float32))
