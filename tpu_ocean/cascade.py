"""Multi-band spectral cascades — the expert-parallel analogue (D7).

A single Tessendorf patch tiles visibly at its length L. Production ocean
systems superpose B independent spectral "cascades" — same N, different patch
lengths (e.g. 1000 m / 130 m / 17 m) — so each wave band is resolved at its
own scale and tiling decorrelates. The reference has exactly one patch
(SURVEY.md D7 lists cascades as the natural EP analogue: independent experts
with a combine).

Formulation: all per-band trace-time constants are STACKED into
leading-[B] arrays and the band step is vmapped — one fused computation, no
Python-level band loop in the hot path. On a mesh with an 'expert' axis the
[B, ...] state shards band-per-device-group and the final combine (Σ over
bands at shared UV) is the only cross-band communication.

Combined surface at display point (u, v) ∈ [0, 1)²:
    height(u,v)  = Σ_b h_b(u·N, v·N)           (per-band physical x = uv·L_b)
    disp/slopes sum likewise; normals and Jacobian foam are computed from the
    COMBINED fields (fields.py), with world spacing display_length / N.

Field-contract note: because each band carries its OWN choppiness, the
returned OceanFields.disp_x/disp_z are the EFFECTIVE (post-choppiness)
combined displacements — i.e. the fields behave as if choppiness were 1:
pos_x = x0 − disp_x directly. This deviates from the single-patch
OceanSolver contract ("disp = raw, pos = x0 − chop·disp"), which cannot
represent a per-band-weighted sum with a single scalar.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_ocean.config import OceanConfig
from tpu_ocean.evolve import (omega_grid, spectrum_coefficients,
                              assemble_spectra, evolve_phase_accumulate)
from tpu_ocean.spectra import h0_pair_fft, h0_pair_centered
from tpu_ocean.fft import check_backend, get_ifft2
from tpu_ocean.fft.reference import (ifft2_planes, ifft2_planes_half,
                                     irfft2_half)
from tpu_ocean import fields as field_ops
from tpu_ocean.solver import OceanFields


class CascadeState(NamedTuple):
    h0: jax.Array        # [B, N, N] complex64
    h0_conj: jax.Array   # [B, N, N]
    phase: jax.Array     # [B, N, N] float32
    t: jax.Array         # scalar
    step: jax.Array      # scalar


class CascadeStateReal(NamedTuple):
    """All-float32 twin of CascadeState — the banded analogue of
    solver.OceanStateReal (state and checkpoints hold f32 planes only)."""
    h0_re: jax.Array      # [B, N, N] each
    h0_im: jax.Array
    h0c_re: jax.Array
    h0c_im: jax.Array
    phase: jax.Array
    t: jax.Array
    step: jax.Array


def extract_live_planes_real(re: jnp.ndarray, im: jnp.ndarray, nch: int,
                             packed: bool, last=None) -> jnp.ndarray:
    """(re, im) [S, C_t, N, N] f32 transform planes → [S, C_live, N, N] live
    field planes (height, disp_x, disp_z[, slope_x, slope_z]).

    The SINGLE home of the packed/unpacked Re-Im plane map for band-stacked
    transforms (mirrors OceanSolver._extract_planes; packed pairing defined
    by evolve.packed_coefficients) — CascadeSolver and lod.LODCascadeSolver
    both consume it, so a pairing change lands in one place. ``last`` [S, N,
    N] is the half-spectrum route's real plane for the final packed field
    (re/im then hold the other packed channels).
    """
    if packed:
        rows = [re[:, 0], im[:, 0]]
        if nch == 5:
            rows += [re[:, 1], im[:, 1], re[:, 2] if last is None else last]
        else:
            rows += [re[:, 1] if last is None else last]
    else:
        rows = [re[:, 0], im[:, 1], im[:, 2]]
        if nch == 5:
            rows += [im[:, 3], im[:, 4]]
    return jnp.stack(rows, axis=1)


def extract_live_planes(f: jnp.ndarray, nch: int, packed: bool,
                        last=None) -> jnp.ndarray:
    """Complex twin of extract_live_planes_real: [S, C_t, N, N] transforms
    → [S, C_live, N, N] live field planes."""
    return extract_live_planes_real(jnp.real(f), jnp.imag(f), nch, packed,
                                    last)


class CascadeSolver:
    """B spectral bands stepped and combined in one jitted call.

    ``cfgs`` must share resolution and mode switches; lengths / winds /
    amplitudes / choppiness may differ per band. ``mesh`` with an 'expert'
    axis shards the band dimension (B divisible by its size).
    """

    def __init__(self, cfgs: Sequence[OceanConfig],
                 fft_backend: str = "reference",
                 display_length: Optional[float] = None,
                 mesh: Optional[Mesh] = None,
                 pack_channels: bool = False,
                 real_state: bool = False,
                 half_spectrum: bool = False):
        if not cfgs:
            raise ValueError("need at least one band config")
        if any(c.foam_decay for c in cfgs):
            # CascadeState carries no per-band foam accumulator; silently
            # recomputing instantaneous foam while the config promises
            # persistence would be the worst outcome — fail fast with the
            # working alternative named (review finding, r5)
            raise ValueError("foam_decay (persistent foam) is not "
                             "implemented for cascades; use foam_decay=0 "
                             "here, or a single-patch OceanSolver/"
                             "DistributedOceanSolver which support it")
        check_backend(fft_backend)
        if real_state and fft_backend != "reference":
            # the all-real step rides the plane transforms of fft.reference
            # — same rule as OceanSolver(real_state=True)
            raise ValueError("real_state cascades run the plane transforms "
                             "of fft.reference; use fft_backend='reference'")
        self.real_state = bool(real_state)
        n = cfgs[0].resolution
        for c in cfgs[1:]:
            if (c.resolution != n
                    or c.evolution_mode != cfgs[0].evolution_mode
                    or c.dispersion_mode != cfgs[0].dispersion_mode
                    or c.spectrum_layout != cfgs[0].spectrum_layout):
                raise ValueError("cascade bands must share resolution and "
                                 "mode switches")
        if cfgs[0].spectrum_layout != "fft":
            raise ValueError("cascades use the 'fft' (GPU) spectrum layout")
        self.cfgs = list(cfgs)
        self.n = n
        self.b = len(cfgs)
        self.mesh = mesh
        self.fft_backend = fft_backend
        self._display_length_arg = display_length   # None → derived from bands
        self.display_length = (display_length if display_length is not None
                               else max(c.length for c in cfgs))

        # stacked trace-time constants: device-put once, passed as step
        # ARGUMENTS (closure-embedded N² grids would become constants
        # compiled into the program)
        self._omega = jax.device_put(
            np.stack([np.asarray(omega_grid(c), np.float32)
                      for c in cfgs]))                             # [B, N, N]
        # stencil normals never read the slope spectra: B×3 transforms, not
        # B×5 (same live-channel rule as OceanSolver._nch); Hermitian
        # packing (evolve.packed_coefficients) further pairs fields into
        # shared transforms — B×2 — under the same default-off parity-ledger
        # terms as the single-patch solver (docs/parity.md)
        self._nch = 3 if cfgs[0].normals_mode == "stencil" else 5
        self.pack_channels = bool(pack_channels)
        self._pch = ((2 if self._nch == 3 else 3) if pack_channels
                     else self._nch)
        # Half-spectrum (C2R) route for the last packed channel of EVERY
        # band, batched into one C2R call over the band axis (bands share N
        # by construction) — B live-field triples on B×1.5
        # transform-equivalents. Same flag constraints as OceanSolver.
        if half_spectrum:
            if not pack_channels:
                raise ValueError("half_spectrum rides the last PACKED "
                                 "channel's Hermitian structure — it "
                                 "requires pack_channels=True")
            if fft_backend != "reference":
                raise ValueError("half_spectrum runs the C2R transform of "
                                 "fft.reference; use fft_backend='reference'")
            if n % 2:
                raise ValueError(f"half_spectrum needs an even resolution "
                                 f"(got {n})")
        self.half_spectrum = bool(half_spectrum)
        if pack_channels:
            from tpu_ocean.evolve import packed_coefficients
            self._coeffs = jax.device_put(
                np.stack([np.asarray(packed_coefficients(c, self._nch),
                                     np.float32)
                          for c in cfgs]))                        # [B, 2P, N, N]
        else:
            self._coeffs = jax.device_put(
                np.stack([np.asarray(spectrum_coefficients(c).real,
                                     np.float32)[:self._nch]
                          for c in cfgs]))                        # [B, C, N, N]
        # coefficient layout contract: 2P stacked (A, B) halves when packed
        # (evolve.packed_coefficients), C live channels otherwise
        assert self._coeffs.shape[1] == (2 * self._pch if pack_channels
                                         else self._nch)
        self._chop = np.asarray([c.choppiness for c in cfgs], np.float32)
        self._dtmul = np.asarray([c.dt_multiplier for c in cfgs], np.float32)
        x1d = (np.arange(n, dtype=np.float32)
               * np.float32(self.display_length / n))
        x0, z0 = np.meshgrid(x1d, x1d, indexing="ij")
        self._x0 = jax.device_put(np.ascontiguousarray(x0))
        self._z0 = jax.device_put(np.ascontiguousarray(z0))
        self._ifft2 = get_ifft2(fft_backend, n, cfgs[0].precision)
        # lazily traced all-real velocity programs (one trace each, reused
        # per streamed frame — ADVICE r2 medium)
        self._velocity_real_jit = None
        self._velocity_held_jit = None

        step = self._step_impl_real if real_state else self._step_impl
        if mesh is not None and "expert" in mesh.axis_names:
            espec = NamedSharding(mesh, P("expert"))
            if real_state:
                state_shardings = CascadeStateReal(
                    h0_re=espec, h0_im=espec, h0c_re=espec, h0c_im=espec,
                    phase=espec, t=None, step=None)
            else:
                state_shardings = CascadeState(h0=espec, h0_conj=espec,
                                               phase=espec, t=None, step=None)
            # omega/coeffs shard along their band axis like the state
            self._step_jit = jax.jit(
                step, donate_argnums=(0,),
                in_shardings=(state_shardings, None, espec, espec,
                              None, None))
        else:
            self._step_jit = jax.jit(step, donate_argnums=(0,))

    # ---------------------------------------------------------------- init

    def init(self, key: Optional[jax.Array] = None):
        if key is None:
            key = jax.random.PRNGKey(self.cfgs[0].seed)
        keys = jax.random.split(key, self.b)
        if self.real_state:
            return self._init_real(keys)
        h0s, h0cs = [], []
        for c, k in zip(self.cfgs, keys):
            pair = (h0_pair_centered if c.spectrum_layout == "centered"
                    else h0_pair_fft)
            h0, h0c = pair(k, c.resolution, c.length, c.phillips_amplitude,
                           c.wind, c.damping, model=c.spectrum_model,
                           jonswap_kw=c.jonswap_kw)
            h0s.append(h0)
            h0cs.append(h0c)
        h0 = jnp.stack(h0s)
        h0c = jnp.stack(h0cs)
        if self.pack_channels:
            # per-band Hermitian projection, exactly as OceanSolver.init
            from tpu_ocean.evolve import hermitize_pair
            h0, h0c = jax.vmap(hermitize_pair)(h0, h0c)
        st = CascadeState(
            h0=h0, h0_conj=h0c,
            phase=jnp.zeros((self.b, self.n, self.n), jnp.float32),
            t=jnp.zeros((), jnp.float32),
            step=jnp.zeros((), jnp.int32))
        if self.mesh is not None and "expert" in self.mesh.axis_names:
            espec = NamedSharding(self.mesh, P("expert"))
            st = CascadeState(
                h0=jax.device_put(st.h0, espec),
                h0_conj=jax.device_put(st.h0_conj, espec),
                phase=jax.device_put(st.phase, espec),
                t=st.t, step=st.step)
        return st

    # ---------------------------------------------------------------- step

    def step(self, state: CascadeState, dt: float = 1.0 / 60.0):
        return self._step_jit(state, jnp.asarray(dt, jnp.float32),
                              self._omega, self._coeffs,
                              self._x0, self._z0)

    def _init_real(self, keys) -> CascadeStateReal:
        """All-f32 init: per-band h0 planes drawn bit-identically to the
        complex path (spectra.h0_pair_fft_planes), hermitized when packing —
        complex64 never enters the process."""
        from tpu_ocean.spectra import h0_pair_fft_planes
        planes = [h0_pair_fft_planes(k, c.resolution, c.length,
                                     c.phillips_amplitude, c.wind, c.damping,
                                     model=c.spectrum_model,
                                     jonswap_kw=c.jonswap_kw)
                  for c, k in zip(self.cfgs, keys)]
        r1, i1, r2, i2 = (jnp.stack([p[j] for p in planes])
                          for j in range(4))
        if self.pack_channels:
            from tpu_ocean.evolve import hermitize_planes
            r1, i1, r2, i2 = jax.vmap(hermitize_planes)(r1, i1, r2, i2)
        st = CascadeStateReal(
            h0_re=r1, h0_im=i1, h0c_re=r2, h0c_im=i2,
            phase=jnp.zeros((self.b, self.n, self.n), jnp.float32),
            t=jnp.zeros((), jnp.float32),
            step=jnp.zeros((), jnp.int32))
        if self.mesh is not None and "expert" in self.mesh.axis_names:
            # pre-place band-sharded like the complex init: otherwise the
            # first step reshards and the state donation cannot alias
            espec = NamedSharding(self.mesh, P("expert"))
            st = st._replace(
                h0_re=jax.device_put(st.h0_re, espec),
                h0_im=jax.device_put(st.h0_im, espec),
                h0c_re=jax.device_put(st.h0c_re, espec),
                h0c_im=jax.device_put(st.h0c_im, espec),
                phase=jax.device_put(st.phase, espec))
        return st

    def reconfigure(self, state, new_cfgs: Sequence[OceanConfig], key=None):
        """Live per-band parameter change: returns (new_solver, new_state).

        The cascade twin of OceanSolver.reconfigure (VERDICT r3 #6), and the
        banded analogue of the reference's runtime re-init
        (OceanRenderer.cs:98-109: changed params re-blit ONE spectrum
        texture; the recurrent phase is NOT reset, so waves keep their
        motion while the sea state morphs). Changes restricted to init-only
        fields (wind, amplitude, spectrum shape, seed — OceanSolver.
        _INIT_ONLY_FIELDS) re-render the per-band h0 planes and REUSE the
        compiled step: no retrace, no constant rebuild. Anything else
        (length, choppiness, resolution, modes) rebuilds the solver,
        carrying phase/t/step over when the grid and layout are unchanged.
        """
        import copy
        import dataclasses
        from tpu_ocean.solver import OceanSolver
        new_cfgs = list(new_cfgs)
        if len(new_cfgs) != self.b:
            raise ValueError(f"got {len(new_cfgs)} band configs for a "
                             f"{self.b}-band cascade; reconfigure cannot "
                             f"add/remove bands (rebuild instead)")
        changed = set()
        for old, new in zip(self.cfgs, new_cfgs):
            changed |= {f.name for f in dataclasses.fields(new)
                        if getattr(new, f.name) != getattr(old, f.name)}
        if key is None:
            key = jax.random.PRNGKey(new_cfgs[0].seed)
        if changed <= OceanSolver._INIT_ONLY_FIELDS:
            solver = copy.copy(self)    # shares _step_jit and all constants
            solver.cfgs = new_cfgs
            fresh = solver.init(key)
            return solver, fresh._replace(phase=state.phase, t=state.t,
                                          step=state.step)
        solver = CascadeSolver(new_cfgs, fft_backend=self.fft_backend,
                               display_length=self._display_length_arg,
                               mesh=self.mesh,
                               pack_channels=self.pack_channels,
                               real_state=self.real_state,
                               half_spectrum=self.half_spectrum)
        fresh = solver.init(key)
        if (new_cfgs[0].resolution == self.cfgs[0].resolution
                and new_cfgs[0].spectrum_layout
                == self.cfgs[0].spectrum_layout):
            fresh = fresh._replace(phase=state.phase, t=state.t,
                                   step=state.step)
        return solver, fresh

    def symmetrize(self, state):
        """Per-band Hermitian projection when packing (idempotent — see
        OceanSolver.symmetrize); no-op otherwise. Applied to resumed
        checkpoints so pre-packing snapshots continue correctly."""
        if not self.pack_channels:
            return state
        if isinstance(state, CascadeStateReal):
            from tpu_ocean.evolve import hermitize_planes
            r1, i1, r2, i2 = jax.vmap(hermitize_planes)(
                state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
            return state._replace(h0_re=r1, h0_im=i1, h0c_re=r2, h0c_im=i2)
        from tpu_ocean.evolve import hermitize_pair
        a, ac = jax.vmap(hermitize_pair)(state.h0, state.h0_conj)
        return state._replace(h0=a, h0_conj=ac)

    def _step_impl(self, state: CascadeState, dt: jax.Array,
                   omega=None, coeffs=None, x0=None, z0=None):
        cfg0 = self.cfgs[0]
        if omega is None:
            omega, coeffs = self._omega, self._coeffs
        if x0 is None:
            x0, z0 = self._x0, self._z0
        if cfg0.evolution_mode == "absolute":
            t_new = state.t + dt / cfg0.t_division
            phase = omega * t_new
            phase_state = state.phase
        else:
            phase = evolve_phase_accumulate(
                state.phase, omega, dt * self._dtmul[:, None, None])
            phase_state = phase
            t_new = state.t + dt

        # [B, C, N, N] band spectra (C = live or packed channels), one
        # batched IFFT over the trailing axes
        if self.pack_channels:
            from tpu_ocean.evolve import assemble_spectra_packed
            spectra = jax.vmap(assemble_spectra_packed)(
                state.h0, state.h0_conj, phase, coeffs)
        else:
            spectra = jax.vmap(assemble_spectra)(state.h0, state.h0_conj,
                                                 phase, coeffs)
        # combine bands at shared UV: Σ over B (the EP all-reduce)
        out = self._combine_fields(self._complex_planes(spectra), x0, z0)
        new_state = CascadeState(h0=state.h0, h0_conj=state.h0_conj,
                                 phase=phase_state, t=t_new,
                                 step=state.step + 1)
        return new_state, out

    def velocity(self, state, t=None) -> jnp.ndarray:
        """Combined vertical surface velocity ∂h/∂t [N, N] — Σ over bands of
        the per-band iω-weighted spectrum (OceanSolver.velocity, lifted over
        the band axis; each band carries its own dt_multiplier rate in phase
        mode).

        CascadeStateReal rides a cached jitted all-real program (cheap to
        stream from a real_state CascadeSimulation, ADVICE r2); the complex
        state keeps the diagnostic-grade jnp.fft path."""
        cfg0 = self.cfgs[0]
        if cfg0.evolution_mode == "absolute":
            tt = state.t if t is None else jnp.asarray(t, jnp.float32)
        else:
            if t is not None:
                raise ValueError("phase mode accumulates incrementally: "
                                 "velocity is defined at the state's "
                                 "current phase (pass no t)")
            tt = state.t
        if isinstance(state, CascadeStateReal):
            if self._velocity_real_jit is None:
                from functools import partial
                self._velocity_real_jit = jax.jit(
                    partial(self._velocity_real_impl, False))
            return self._velocity_real_jit(state, tt, self._omega)
        return self._velocity_complex(state, tt, held_phase=False)

    def velocity_at_held_phase(self, state) -> jnp.ndarray:
        """Velocity with every band evaluated at the phase stored in
        ``state.phase`` regardless of evolution mode — the LOD scheduler's
        contract (lod.py keeps each band's LAST-REFRESH phase there, even in
        absolute mode), so the returned rate matches the DISPLAYED (held)
        surface, not the current clock. Rate factor: dt_multiplier in phase
        mode (φ advances by ω·dt·mul per wall dt), 1 in absolute mode."""
        if isinstance(state, CascadeStateReal):
            if self._velocity_held_jit is None:
                from functools import partial
                self._velocity_held_jit = jax.jit(
                    partial(self._velocity_real_impl, True))
            return self._velocity_held_jit(state, state.t, self._omega)
        return self._velocity_complex(state, state.t, held_phase=True)

    def _velocity_complex(self, state, tt, held_phase: bool) -> jnp.ndarray:
        cfg0 = self.cfgs[0]
        h0, h0c = state.h0, state.h0_conj
        om = self._omega
        if cfg0.evolution_mode == "absolute" and not held_phase:
            phase = om * tt
        else:
            phase = state.phase
        if cfg0.evolution_mode == "absolute":
            rate = jnp.ones((self.b, 1, 1), jnp.float32)
        else:
            rate = jnp.asarray(self._dtmul)[:, None, None]
        pv = jnp.cos(phase) + 1j * jnp.sin(phase)
        vspec = (1j * rate) * om * (h0 * pv - h0c * jnp.conj(pv))
        n = self.n
        return jnp.sum(jnp.real(jnp.fft.ifft2(vspec)) * (n * n), axis=0)

    def _velocity_real_impl(self, held_phase: bool, state, tt, omega):
        """All-real banded ∂h/∂t (algebra: solver._velocity_real_impl),
        one plane transform over the band batch, Σ over bands."""
        cfg0 = self.cfgs[0]
        if cfg0.evolution_mode == "absolute" and not held_phase:
            phase = omega * tt
        else:
            phase = state.phase
        if cfg0.evolution_mode == "absolute":
            rate = np.ones((self.b, 1, 1), np.float32)
        else:
            rate = np.asarray(self._dtmul, np.float32)[:, None, None]
        cph = jnp.cos(phase)
        sph = jnp.sin(phase)
        a, b = state.h0_re, state.h0_im
        cc, d = state.h0c_re, state.h0c_im
        diff_re = (a - cc) * cph - (b + d) * sph
        diff_im = (b - d) * cph + (a + cc) * sph
        w = rate * omega
        if self.half_spectrum:
            # banded twin of OceanSolver's C2R velocity: every band's v̂ is
            # exactly Hermitian under the packed projection — one batched
            # half transform over the band axis, Σ over bands
            mh = self.n // 2
            re = ifft2_planes_half(-(w * diff_im)[:, :mh + 1],
                                   (w * diff_re)[:, :mh + 1])
            return jnp.sum(re, axis=0)
        re, _ = ifft2_planes(-(w * diff_im), w * diff_re)
        return jnp.sum(re, axis=0)

    def _complex_planes(self, spectra) -> jnp.ndarray:
        """[S, C_t, N, N] complex band spectra → [S, C_live, N, N] live
        planes: ONE batched transform over the band×channel batch, and with
        half_spectrum one batched C2R transform for every band's last
        packed channel (exactly Hermitian after symmetrize). Shared by
        _step_impl and the LOD scheduler's refresh."""
        last = None
        if self.half_spectrum:
            last = irfft2_half(spectra[:, -1, :self.n // 2 + 1])   # [S,N,N]
            spectra = spectra[:, :-1]
        return extract_live_planes(self._ifft2(spectra), self._nch,
                                   self.pack_channels, last)

    def _real_planes(self, pair, phase, coeffs) -> jnp.ndarray:
        """Banded all-f32 assembly + ONE plane transform over the band×
        channel batch → [S, C_live, N, N] live planes. The single home of
        the real-state refresh math (consumed by _step_impl_real and the
        LOD scheduler's refresh — lod._transform_planes)."""
        if self.pack_channels:
            from tpu_ocean.evolve import assemble_spectra_packed_real
            re, im = jax.vmap(assemble_spectra_packed_real,
                              in_axes=((0, 0, 0, 0), 0, 0))(pair, phase,
                                                            coeffs)
        else:
            from tpu_ocean.evolve import assemble_spectra_real
            re, im = jax.vmap(assemble_spectra_real,
                              in_axes=((0, 0, 0, 0), 0, 0))(pair, phase,
                                                            coeffs)
        last = None
        if self.half_spectrum:
            # last packed channel of every band is exactly Hermitian after
            # symmetrize: one batched C2R transform over the band axis
            mh = self.n // 2
            last = ifft2_planes_half(re[:, -1, :mh + 1],
                                     im[:, -1, :mh + 1])          # [S, N, N]
            re, im = re[:, :-1], im[:, :-1]
        re, im = ifft2_planes(re, im)
        return extract_live_planes_real(re, im, self._nch,
                                        self.pack_channels, last)

    def _combine_fields(self, planes: jnp.ndarray, x0, z0) -> OceanFields:
        """[B, C, N, N] live planes → combined OceanFields (Σ over bands,
        then normals/foam). Shared by both state representations and the
        LOD scheduler."""
        cfg0 = self.cfgs[0]
        chop = self._chop[:, None, None]
        height = jnp.sum(planes[:, 0], axis=0)
        disp_x = jnp.sum(chop * planes[:, 1], axis=0)
        disp_z = jnp.sum(chop * planes[:, 2], axis=0)
        texel = self.display_length / self.n
        if cfg0.normals_mode == "spectral":
            slope_x = jnp.sum(planes[:, 3], axis=0)
            slope_z = jnp.sum(planes[:, 4], axis=0)
            normal = field_ops.normals_spectral(slope_x, slope_z)
            foam, jac = field_ops.whitecap_gpu(disp_x, disp_z, normal)
        else:
            normal = field_ops.normals_stencil(disp_x, height, disp_z, texel)
            foam, jac = field_ops.whitecap_gpu(disp_x, disp_z, normal)
        return OceanFields(height=height, disp_x=disp_x, disp_z=disp_z,
                           pos_x=x0 - disp_x, pos_z=z0 - disp_z,
                           normal=normal, foam=foam, jacobian=jac)


    def _step_impl_real(self, state: CascadeStateReal, dt: jax.Array,
                        omega=None, coeffs=None, x0=None, z0=None):
        """All-f32 twin of _step_impl: banded real-plane assembly → one
        plane transform over the [B, C] channel batch → live-plane combine.
        Same math on f32 state planes."""
        cfg0 = self.cfgs[0]
        if omega is None:
            omega, coeffs = self._omega, self._coeffs
        if x0 is None:
            x0, z0 = self._x0, self._z0
        if cfg0.evolution_mode == "absolute":
            t_new = state.t + dt / cfg0.t_division
            phase = omega * t_new
            phase_state = state.phase
        else:
            phase = evolve_phase_accumulate(
                state.phase, omega, dt * self._dtmul[:, None, None])
            phase_state = phase
            t_new = state.t + dt

        pair = (state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
        planes = self._real_planes(pair, phase, coeffs)
        out = self._combine_fields(planes, x0, z0)
        new_state = CascadeStateReal(
            h0_re=state.h0_re, h0_im=state.h0_im,
            h0c_re=state.h0c_re, h0c_im=state.h0c_im,
            phase=phase_state, t=t_new, step=state.step + 1)
        return new_state, out


def default_cascade(n: int = 256, lengths=(1000.0, 130.0, 17.0),
                    wind=(14.0, 12.0), amplitude: float = 0.4,
                    choppiness: float = 0.6) -> List[OceanConfig]:
    """A standard 3-band production cascade parameterization."""
    return [OceanConfig(resolution=n, length=l, wind=wind,
                        amplitude=amplitude, amplitude_scale=1e-4,
                        choppiness=choppiness,
                        evolution_mode="phase", dispersion_mode="capillary",
                        spectrum_layout="fft", normals_mode="stencil",
                        damping=0.01, oracle_sign_quirk=False, seed=i)
            for i, l in enumerate(lengths)]
