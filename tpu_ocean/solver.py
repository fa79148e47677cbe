"""The end-to-end ocean solver: init() / step() over an OceanState pytree (L3).

The reference schedules ~44 fragment passes per frame from the CPU
(OceanRenderer.cs:216-316: dispersion → spectrum ×2 → 4·log2 N Stockham blits →
normal → whitecap), each a host→device round trip. Here the whole step is ONE
jitted function: spectrum assembly, a batched 5-channel 2-D IFFT, and the
derived-field stencils all fuse under XLA (SURVEY.md §7 design stance).

State (C18, the reference's 10 RenderTextures collapse to):
    h0, h0_conj : complex64 [N, N]   — initial spectrum pair (InitialSpectrum)
    phase       : float32 [N, N]     — recurrent phase (phase mode only)
    t           : float32 scalar     — sim time (absolute mode)
    step        : int32 scalar

Evaluation modes:
    * ``fft``    — batched unnormalized inverse FFT (backend-selectable);
                   centered layout additionally applies the pre/post modulation
                   that lands the DFT exactly on the oracle's mesh positions.
    * ``direct`` — two complex matmuls per channel: the oracle's direct sum,
                   vectorized. O(N³); also the only exact evaluator when
                   length ≠ resolution·unit_width.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from tpu_ocean.config import OceanConfig
from tpu_ocean import grids
from tpu_ocean.evolve import (
    omega_grid,
    spectrum_coefficients,
    packed_coefficients,
    evolve_phase_accumulate,
    assemble_spectra,
    assemble_spectra_packed,
)
from tpu_ocean.spectra import h0_pair_centered, h0_pair_fft
from tpu_ocean.fft import check_backend, get_ifft2
from tpu_ocean.fft.reference import (centered_modulation, ifft2_planes,
                                     ifft2_planes_half, irfft2_half)
from tpu_ocean import fields as field_ops


class OceanState(NamedTuple):
    h0: jax.Array
    h0_conj: jax.Array
    phase: jax.Array
    t: jax.Array
    step: jax.Array
    # accumulated foam (zeros when cfg.foam_decay == 0 — pure passthrough)
    foam_accum: jax.Array


class OceanStateReal(NamedTuple):
    """All-float32 twin of OceanState: h0 carried as (re, im) planes.

    With ``OceanSolver(real_state=True)`` the state, the step's inputs and
    its outputs are real-valued: the spectrum is assembled as f32 planes and
    meets complex64 only inside the plane transforms of fft.reference
    (``lax.complex`` → jnp.fft → real/imag). Checkpoints and the wire carry
    plain f32 arrays.
    """
    h0_re: jax.Array
    h0_im: jax.Array
    h0c_re: jax.Array
    h0c_im: jax.Array
    phase: jax.Array
    t: jax.Array
    step: jax.Array
    foam_accum: jax.Array


class OceanFields(NamedTuple):
    """Prognostic output fields, [N, N] (normal: [N, N, 3]); axis0=x, axis1=z."""
    height: jax.Array
    disp_x: jax.Array      # raw horizontal displacement (pre-choppiness)
    disp_z: jax.Array
    pos_x: jax.Array       # displaced positions: x0 − chop·disp_x (FFTMesh.cs:245)
    pos_z: jax.Array
    normal: jax.Array
    foam: jax.Array
    jacobian: jax.Array


#: the shipping switch set (the OceanSolver / DistributedOceanSolver /
#: CascadeSolver keywords of ``python -m tpu_ocean ocean --production``,
#: bench.py's headline and __graft_entry__.entry): f32 plane state,
#: Hermitian channel packing and the half-spectrum C2R route for the last
#: packed channel, on the jnp.fft backend. Needs an even resolution.
PRODUCTION = dict(real_state=True, pack_channels=True, half_spectrum=True)


class OceanSolver:
    """Builds and owns the jitted step for a fixed OceanConfig."""

    def __init__(self, cfg: OceanConfig, fft_backend: str = "reference",
                 eval_mode: str = "fft", real_state: bool = False,
                 pack_channels: Optional[bool] = None,
                 half_spectrum: bool = False):
        if eval_mode not in ("fft", "direct"):
            raise ValueError(f"bad eval_mode {eval_mode!r}")
        check_backend(fft_backend)
        if real_state:
            # the all-real step transforms (re, im) planes through
            # fft.reference and needs the fft (GPU-convention) layout — the
            # centered modulation factors are complex
            if fft_backend != "reference":
                raise ValueError("real_state runs the plane transforms of "
                                 "fft.reference; use fft_backend='reference'")
            if cfg.spectrum_layout != "fft" or eval_mode != "fft":
                raise ValueError("real_state requires spectrum_layout='fft' "
                                 "and eval_mode='fft'")
        self.real_state = real_state
        if eval_mode == "direct" and cfg.spectrum_layout != "centered":
            raise ValueError("direct evaluation implements the centered "
                             "(oracle) layout only")
        self.cfg = cfg
        self.eval_mode = eval_mode
        n = cfg.resolution
        self.fft_backend = fft_backend

        # ---- trace-time constants ----
        # Built as float64 numpy, then device_put ONCE and passed to the
        # jitted step as ARGUMENTS: closed-over numpy arrays would be
        # EMBEDDED in the program body (N² grids — at 4096² the coefficient
        # grids alone are hundreds of MB of constants to compile). All
        # constants here are real-valued, so they travel as f32.
        # stencil normals never read the slope spectra (channels 3, 4):
        # transform only the 3 live channels — 40% less FFT work, memory
        # traffic, and (distributed) transpose volume on the flagship
        # GPU-convention path. XLA's DCE cannot remove single channels of
        # a batched FFT, so it is explicit.
        self._nch = 3 if cfg.normals_mode == "stencil" else 5
        # Hermitian channel packing (evolve.packed_coefficients): every
        # output field is real, so pairs of channels share one complex
        # transform — 3 live channels ride 2 FFTs, 5 ride 3. DEFAULT OFF
        # (parity ledger, docs/parity.md): it requires symmetrize()'s
        # Hermitian projection, which drops the reference's Nyquist-line
        # Im-content from the displacement fields — negligible at damped
        # production configs, ~15% L∞ on small undamped grids.
        can_pack = (eval_mode == "fft" and cfg.spectrum_layout == "fft")
        if pack_channels is None:
            pack_channels = False
        elif pack_channels and not can_pack:
            raise ValueError("pack_channels requires spectrum_layout='fft' "
                             "and eval_mode='fft' (the centered/direct "
                             "channels do not Re/Im-separate — see "
                             "evolve.packed_coefficients)")
        self.pack_channels = bool(pack_channels)
        #: channels actually transformed (= _nch unless packed)
        self._pch = ((2 if self._nch == 3 else 3) if self.pack_channels
                     else self._nch)
        # Half-spectrum (C2R) route for the LAST packed channel: that
        # channel carries a single real field (A = 0 in
        # evolve.packed_coefficients → its spectrum is exactly Hermitian
        # after symmetrize), so fft.reference.irfft2_half transforms only
        # spectral rows 0..N/2 — ~half that channel's transform cost. 3 live
        # fields then ride 1.5 transform-equivalents (the information
        # floor), down from packing's 2. Requires the Hermitian projection
        # packing already performs, hence pack_channels.
        if half_spectrum:
            if not self.pack_channels:
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
        consts = {
            "omega": np.asarray(omega_grid(cfg), dtype=np.float32),
        }
        if self.pack_channels:
            consts["pack"] = np.asarray(
                packed_coefficients(cfg, self._nch), dtype=np.float32)
        else:
            # channel coefficients are REAL (evolve.spectrum_coefficients)
            consts["coeffs"] = np.asarray(
                spectrum_coefficients(cfg).real,
                dtype=np.float32)[:self._nch]

        if cfg.spectrum_layout == "centered":
            x1d = grids.coordinate_1d(n, cfg.unit_width)
        else:
            x1d = np.arange(n, dtype=np.float64) * (cfg.length / n)
        x0, z0 = np.meshgrid(x1d, x1d, indexing="ij")
        consts["x0"] = np.asarray(x0, dtype=np.float32)
        consts["z0"] = np.asarray(z0, dtype=np.float32)

        # lazily traced all-real velocity (one trace, reused every frame by
        # serve.FrameServer — ADVICE r2 medium)
        self._velocity_real_jit = None

        if eval_mode == "fft":
            self._ifft2 = get_ifft2(fft_backend, n, cfg.precision)
            self._has_modulation = False
            if cfg.spectrum_layout == "centered":
                self._add_modulation(consts, n)
        else:
            # Direct DFT basis E[n, i] = e^{i k_n x_i} (oracle convention,
            # FFTMesh.cs:205-208) — valid for any length/unit_width pairing.
            k1d = grids.wavenumbers_1d(n, cfg.length, "centered")
            ex = np.exp(1j * np.outer(k1d, x1d))
            consts["ex_re"] = np.asarray(ex.real, np.float32)
            consts["ex_im"] = np.asarray(ex.imag, np.float32)
            self._has_modulation = False
            self._ifft2 = None   # _transform takes the direct-DFT path

        self._consts = {k: jax.device_put(v) for k, v in consts.items()}
        self._step_jit = jax.jit(self._step_impl, donate_argnums=(0,))

    def _add_modulation(self, consts, n):
        pre, post = centered_modulation(n, self.cfg.length,
                                        self.cfg.unit_width)
        consts["pre_re"] = np.asarray(pre.real, np.float32)
        consts["pre_im"] = np.asarray(pre.imag, np.float32)
        consts["post_re"] = np.asarray(post.real, np.float32)
        consts["post_im"] = np.asarray(post.imag, np.float32)
        self._has_modulation = True

    # ------------------------------------------------------------------ init

    def symmetrize(self, state):
        """Project the h0 pair onto its Hermitian part (packed solvers).

        The reference draws h0_conj INDEPENDENTLY of h0 (FFTMesh.cs:114-116,
        spectra.h0_pair_fft), so h̃ is not Hermitian — but the extraction
        only ever keeps Re F(h̃) and Im F(r·h̃), which equal F(H(h̃)) and
        F(r·H(h̃)) for the Hermitian part H(S) = ½(S + conj(S∘neg)). With
        h̃ = h0·e^{iφ} + h0c·e^{−iφ} and φ(−k) = φ(k),

            H(h̃) = a·e^{iφ} + conj(a∘neg)·e^{−iφ},
            a    = ½(h0 + conj(h0c∘neg)),

        so replacing (h0, h0c) by (a, conj(a∘neg)) once at init makes the
        state exactly Hermitian while changing no extracted field beyond f32
        rounding (except damped Nyquist-line modes — docs/parity.md). The
        projection is BITWISE idempotent: on an already-symmetric state
        conj(h0c∘neg) == h0 exactly, and ½(x + x) = x in fp — so applying
        it to a resumed checkpoint is safe regardless of which convention
        wrote it (runtime.Simulation does).
        """
        if not self.pack_channels:
            return state
        from tpu_ocean.evolve import hermitize_pair, hermitize_planes
        if isinstance(state, OceanStateReal):
            ar, ai, acr, aci = hermitize_planes(
                state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
            return state._replace(h0_re=ar, h0_im=ai, h0c_re=acr, h0c_im=aci)
        a, ac = hermitize_pair(state.h0, state.h0_conj)
        return state._replace(h0=a, h0_conj=ac)

    def init(self, key: Optional[jax.Array] = None,
             h0: Optional[jax.Array] = None,
             h0_conj: Optional[jax.Array] = None,
             gpu_hash_seeds: Optional[tuple] = None) -> OceanState:
        """Create the initial state: sample h0 from ``key`` (the
        InitialSpectrum pass, InitialSpectrum.shader:42-54), inject given
        spectra (parity tests share one h0 with the oracle), or pass
        ``gpu_hash_seeds=(s1, s2)`` to replay the Unity demo's shader-hash
        spectrum texel-exactly (spectra.h0_pair_gpu_hash)."""
        cfg = self.cfg
        n = cfg.resolution
        if h0 is None and gpu_hash_seeds is not None:
            if cfg.spectrum_layout != "fft":
                raise ValueError("gpu_hash_seeds replays the shader's "
                                 "fft-layout spectrum; it requires "
                                 "spectrum_layout='fft'")
            from tpu_ocean.spectra import h0_pair_gpu_hash
            h0, h0_conj = h0_pair_gpu_hash(
                n, cfg.length, cfg.phillips_amplitude, cfg.wind,
                gpu_hash_seeds[0], gpu_hash_seeds[1], cfg.damping)
        if self.real_state and h0 is None:
            # sample h0 directly as (re, im) planes: bit-identical draw to
            # h0_pair_fft, with no complex array in the state
            from tpu_ocean.spectra import h0_pair_fft_planes
            if key is None:
                key = jax.random.PRNGKey(cfg.seed)
            r1, i1, r2, i2 = h0_pair_fft_planes(
                key, n, cfg.length, cfg.phillips_amplitude, cfg.wind,
                cfg.damping, model=cfg.spectrum_model,
                jonswap_kw=cfg.jonswap_kw)
            return self.symmetrize(OceanStateReal(
                h0_re=r1, h0_im=i1, h0c_re=r2, h0c_im=i2,
                phase=jnp.zeros((n, n), dtype=jnp.float32),
                t=jnp.zeros((), dtype=jnp.float32),
                step=jnp.zeros((), dtype=jnp.int32),
                foam_accum=jnp.zeros((n, n), dtype=jnp.float32),
            ))
        if h0 is None:
            if key is None:
                key = jax.random.PRNGKey(cfg.seed)
            pair_fn = (h0_pair_centered if cfg.spectrum_layout == "centered"
                       else h0_pair_fft)
            h0, h0_conj = pair_fn(key, n, cfg.length, cfg.phillips_amplitude,
                                  cfg.wind, cfg.damping,
                                  model=cfg.spectrum_model,
                                  jonswap_kw=cfg.jonswap_kw)
        # Initial phase = 0: the reference's phase textures start black
        # (OceanRenderer.cs:138-139; SURVEY.md C5).
        if self.real_state:
            # injected-h0 / gpu_hash_seeds path: split the complex pair
            # host-side in numpy (np.asarray pulls a device-resident
            # injection to the host — parity tests and replays only)
            h0_np = np.asarray(h0)
            h0c_np = np.asarray(h0_conj)
            return self.symmetrize(OceanStateReal(
                h0_re=jnp.asarray(np.real(h0_np), jnp.float32),
                h0_im=jnp.asarray(np.imag(h0_np), jnp.float32),
                h0c_re=jnp.asarray(np.real(h0c_np), jnp.float32),
                h0c_im=jnp.asarray(np.imag(h0c_np), jnp.float32),
                phase=jnp.zeros((n, n), dtype=jnp.float32),
                t=jnp.zeros((), dtype=jnp.float32),
                step=jnp.zeros((), dtype=jnp.int32),
                foam_accum=jnp.zeros((n, n), dtype=jnp.float32),
            ))
        h0 = jnp.asarray(h0, dtype=jnp.complex64)
        h0_conj = jnp.asarray(h0_conj, dtype=jnp.complex64)
        return self.symmetrize(OceanState(
            h0=h0,
            h0_conj=h0_conj,
            phase=jnp.zeros((n, n), dtype=jnp.float32),
            t=jnp.zeros((), dtype=jnp.float32),
            step=jnp.zeros((), dtype=jnp.int32),
            foam_accum=jnp.zeros((n, n), dtype=jnp.float32),
        ))

    # ------------------------------------------------------------- reconfigure

    #: config fields consumed ONLY by init() (the InitialSpectrum pass) —
    #: a change restricted to these re-renders h0 without touching the
    #: compiled step, matching the reference's interactive reconfigure cost
    #: (OceanRenderer.cs:98-109 re-blits ONE texture)
    _INIT_ONLY_FIELDS = frozenset({
        "wind", "amplitude", "amplitude_scale", "damping", "seed",
        "spectrum_model", "jonswap_fetch", "jonswap_gamma",
        "jonswap_spreading", "jonswap_depth"})

    def reconfigure(self, state: OceanState, new_cfg: OceanConfig,
                    key: Optional[jax.Array] = None):
        """Live parameter change: returns (new_solver, new_state).

        Mirrors the reference's runtime re-init (OceanRenderer.cs:98-109):
        when length/wind/amplitude change, the initial spectrum is re-rendered
        but the recurrent phase is NOT reset — waves keep their motion while
        the sea state morphs. Changes restricted to init-only fields (wind,
        amplitude, spectrum shape, seed) REUSE the compiled step — no
        retrace, no constant rebuild — so interactive parameter sweeps cost
        one h0 re-render, like the reference. Resolution/layout/physics
        changes rebuild everything.
        """
        import dataclasses
        changed = {f.name for f in dataclasses.fields(new_cfg)
                   if getattr(new_cfg, f.name) != getattr(self.cfg, f.name)}
        if changed <= self._INIT_ONLY_FIELDS:
            import copy
            solver = copy.copy(self)   # shares _step_jit and _consts
            solver.cfg = new_cfg
            fresh = solver.init(key if key is not None
                                else jax.random.PRNGKey(new_cfg.seed))
            return solver, fresh._replace(phase=state.phase, t=state.t,
                                          step=state.step,
                                          foam_accum=state.foam_accum)
        solver = OceanSolver(new_cfg, fft_backend=self.fft_backend,
                             eval_mode=self.eval_mode,
                             real_state=self.real_state,
                             pack_channels=(self.pack_channels
                                            if new_cfg.spectrum_layout
                                            == self.cfg.spectrum_layout
                                            else None),
                             half_spectrum=(self.half_spectrum
                                            if new_cfg.spectrum_layout
                                            == self.cfg.spectrum_layout
                                            else False))
        fresh = solver.init(key if key is not None
                            else jax.random.PRNGKey(new_cfg.seed))
        if (new_cfg.resolution == self.cfg.resolution
                and new_cfg.spectrum_layout == self.cfg.spectrum_layout):
            fresh = fresh._replace(phase=state.phase, t=state.t,
                                   step=state.step,
                                   foam_accum=state.foam_accum)
        return solver, fresh

    # ------------------------------------------------------------------ step

    def step(self, state: OceanState, dt: float = 1.0 / 60.0):
        """Advance one step and return (new_state, OceanFields)."""
        return self._step_jit(state, jnp.asarray(dt, dtype=jnp.float32),
                              self._consts)

    def _step_impl(self, state, dt: jax.Array, c=None):
        cfg = self.cfg
        if c is None:
            # EAGER convenience only (autodiff tests & friends call with
            # two args outside jit). Under jit, pass consts EXPLICITLY:
            # closed-over N² device arrays become constants embedded in the
            # program (solver._step_jit does it right)
            c = self._consts
        if isinstance(state, OceanStateReal):
            return self._step_impl_real(state, dt, c)

        # named scopes mirror the reference's per-pass structure in profiler
        # traces (SURVEY.md §5.1): dispersion → spectrum → FFT → fields
        with jax.named_scope("dispersion"):
            if cfg.evolution_mode == "absolute":
                # timer += dt / tDivision, evaluate at new absolute time
                # (FFTMesh.cs:70-72).
                t_new = state.t + dt / cfg.t_division
                phase = c["omega"] * t_new
                phase_state = state.phase
            else:
                # φ ← (φ + ω·dt·mult) mod 2π (Dispersion.shader:32-41,
                # OceanRenderer.cs:223 dt·mult).
                phase = evolve_phase_accumulate(
                    state.phase, c["omega"], dt * cfg.dt_multiplier)
                phase_state = phase
                t_new = state.t + dt

        f, last = self._evolved_transform(state, phase, c)
        with jax.named_scope("fields"):
            out = self._extract_fields(f, c, last)

        foam_accum = state.foam_accum
        if cfg.foam_decay > 0.0:
            # persistent foam: new crests refresh it, old foam e-folds away
            foam_accum = jnp.maximum(
                out.foam, state.foam_accum
                * jnp.exp(-np.float32(cfg.foam_decay) * dt))
            out = out._replace(foam=foam_accum)

        new_state = OceanState(h0=state.h0, h0_conj=state.h0_conj,
                               phase=phase_state, t=t_new,
                               step=state.step + 1,
                               foam_accum=foam_accum)
        return new_state, out

    def _step_impl_real(self, state: OceanStateReal, dt: jax.Array, c):
        """All-real twin of _step_impl (see OceanStateReal): the spectrum
        is assembled as (re, im) f32 planes and transformed by the plane
        API of fft.reference."""
        cfg = self.cfg
        with jax.named_scope("dispersion"):
            if cfg.evolution_mode == "absolute":
                t_new = state.t + dt / cfg.t_division
                phase = c["omega"] * t_new
                phase_state = state.phase
            else:
                phase = evolve_phase_accumulate(
                    state.phase, c["omega"], dt * cfg.dt_multiplier)
                phase_state = phase
                t_new = state.t + dt

        out = self._fields_from_phase_real(state, phase, c)

        foam_accum = state.foam_accum
        if cfg.foam_decay > 0.0:
            foam_accum = jnp.maximum(
                out.foam, state.foam_accum
                * jnp.exp(-np.float32(cfg.foam_decay) * dt))
            out = out._replace(foam=foam_accum)

        new_state = OceanStateReal(
            h0_re=state.h0_re, h0_im=state.h0_im,
            h0c_re=state.h0c_re, h0c_im=state.h0c_im,
            phase=phase_state, t=t_new, step=state.step + 1,
            foam_accum=foam_accum)
        return new_state, out

    def _fields_from_phase_real(self, state: OceanStateReal, phase, c):
        """All-real transform + field extraction (see OceanStateReal)."""
        pair = (state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
        with jax.named_scope("spectrum_assembly"):
            if self.pack_channels:
                from tpu_ocean.evolve import assemble_spectra_packed_real
                re, im = assemble_spectra_packed_real(pair, phase, c["pack"])
            else:
                from tpu_ocean.evolve import assemble_spectra_real
                re, im = assemble_spectra_real(pair, phase, c["coeffs"])
        last = None
        if self.half_spectrum:
            mh = self.cfg.resolution // 2
            with jax.named_scope("ifft2_half"):
                # XLA narrows the assembly to the sliced rows (the slice
                # feeds the only consumer of channel -1)
                last = ifft2_planes_half(re[-1, :mh + 1], im[-1, :mh + 1])
            re, im = re[:-1], im[:-1]
        with jax.named_scope("ifft2"):
            re, im = ifft2_planes(re, im)
        with jax.named_scope("fields"):
            return self._extract_planes(re, im, last, c)

    def fields_at(self, state, t: float) -> OceanFields:
        """Evaluate fields at an absolute time without advancing state
        (absolute mode only) — mirrors the oracle's stateless EvaluateWaves."""
        if self.cfg.evolution_mode != "absolute":
            # phase mode's per-mode accumulated phase (mod 2π, dt_multiplier
            # applied) is NOT ω·t — returning ω·t fields here would be
            # silently wrong, the same misuse velocity() already refuses
            raise ValueError("fields_at evaluates the stateless absolute-"
                             "time form (ω·t); this solver runs "
                             "evolution_mode='phase' — use step() and read "
                             "the returned fields")
        c = self._consts
        phase = c["omega"] * jnp.asarray(t, dtype=jnp.float32)
        if isinstance(state, OceanStateReal):
            return self._fields_from_phase_real(state, phase, c)
        f, last = self._evolved_transform(state, phase, c)
        return self._extract_fields(f, c, last)

    def velocity(self, state, t: Optional[float] = None) -> jax.Array:
        """Vertical surface velocity ∂h/∂t [N, N] — exact from the
        dispersion relation, no finite differencing:

            ∂ₜ h̃(k) = iω·(h0·e^{iφ} − h0*·e^{−iφ}),   v = Re F(∂ₜ h̃)

        Beyond-reference output (a fragment pipeline has no time axis to
        differentiate along) for spray/wake seeding, Doppler audio cues, and
        fluid-structure coupling. 'absolute' mode evaluates at ``t``
        (default: the state's own clock); 'phase' mode uses the accumulated
        per-mode phase (pass no t).

        Representation split (serving hot path, ADVICE r2): OceanStateReal
        rides a CACHED JITTED all-real program (cos/sin assembly of the
        iω-weighted spectrum + fft.reference.ifft2_planes), so streaming
        velocity from a real_state Simulation costs one trace total. The
        complex states keep the diagnostic-grade generic transform.
        """
        c = self._consts
        if isinstance(state, OceanStateReal):
            if self.cfg.evolution_mode == "absolute":
                tt = state.t if t is None else jnp.asarray(t, jnp.float32)
            else:
                if t is not None:
                    raise ValueError("phase mode accumulates incrementally: "
                                     "velocity is defined at the state's "
                                     "current phase (pass no t)")
                tt = state.t            # unused by the phase-mode closure
            if self._velocity_real_jit is None:
                self._velocity_real_jit = jax.jit(self._velocity_real_impl)
            return self._velocity_real_jit(state, tt, c["omega"])
        h0, h0c = state.h0, state.h0_conj
        if self.cfg.evolution_mode == "absolute":
            tt = state.t if t is None else jnp.asarray(t, jnp.float32)
            phase = c["omega"] * tt
        else:
            if t is not None:
                raise ValueError("phase mode accumulates incrementally: "
                                 "velocity is defined at the state's "
                                 "current phase (pass no t)")
            phase = state.phase
        pv = jnp.cos(phase) + 1j * jnp.sin(phase)
        # phase mode advances φ by ω·dt·dt_multiplier per wall dt
        # (_step_impl), so dφ/dt — and hence ∂h/∂t — carries that factor;
        # absolute mode's clock is the t axis fields_at exposes, already
        # consistent without it
        rate = (self.cfg.dt_multiplier
                if self.cfg.evolution_mode == "phase" else 1.0)
        vspec = (1j * rate) * c["omega"] * (h0 * pv - h0c * jnp.conj(pv))
        return jnp.real(self._transform(vspec[None], c)[0])

    def _velocity_real_impl(self, state: "OceanStateReal", tt, omega):
        """All-real ∂h/∂t: the complex algebra of ``velocity`` expanded into
        f32 planes. With h0 = a+ib, h0* = c+id, e^{iφ} = C+iS:

            h0·e^{iφ} − h0*·e^{−iφ} = [(a−c)C − (b+d)S] + i[(b−d)C + (a+c)S]
            v_spec = iρω·(…)  ⇒  re = −ρω·Im(…), im = ρω·Re(…)

        then v = Re-plane of the unnormalized plane IFFT (ifft2_planes,
        the same transform family the real-state step rides)."""
        cfg = self.cfg
        if cfg.evolution_mode == "absolute":
            phase = omega * tt
        else:
            phase = state.phase
        rate = np.float32(cfg.dt_multiplier
                          if cfg.evolution_mode == "phase" else 1.0)
        cph = jnp.cos(phase)
        sph = jnp.sin(phase)
        a, b = state.h0_re, state.h0_im
        cc, d = state.h0c_re, state.h0c_im
        diff_re = (a - cc) * cph - (b + d) * sph
        diff_im = (b - d) * cph + (a + cc) * sph
        w = rate * omega
        if self.half_spectrum:
            # v̂(k) = iρω(h0·e^{iφ} − h0*·e^{−iφ}) is EXACTLY Hermitian
            # under the packed state's projection (h0*[k] = conj h0[−k],
            # ω even in k) — the same symmetry the height channel rides —
            # so the served velocity plane gets the C2R transform too
            # (rows 0..N/2 only; XLA narrows the assembly to the slice).
            mh = cfg.resolution // 2
            return ifft2_planes_half((-(w * diff_im))[:mh + 1],
                                     (w * diff_re)[:mh + 1])
        re, _ = ifft2_planes(-(w * diff_im), w * diff_re)
        return re

    # ---------------------------------------------------------------- internals

    def _evolved_transform(self, state: OceanState, phase, c):
        """phase [N, N] → (f [C, N, N] complex spatial fields, last): the
        assembly + IFFT. With half_spectrum the last packed channel is
        transformed by the C2R route and returned as the real plane
        ``last`` (f then holds the other channels); otherwise last = None."""
        with jax.named_scope("spectrum_assembly"):
            if self.pack_channels:
                spectra = assemble_spectra_packed(state.h0, state.h0_conj,
                                                  phase, c["pack"])
            else:
                spectra = assemble_spectra(state.h0, state.h0_conj, phase,
                                           c["coeffs"])
        last = None
        if self.half_spectrum:
            mh = self.cfg.resolution // 2
            with jax.named_scope("ifft2_half"):
                last = irfft2_half(spectra[-1, :mh + 1])
            spectra = spectra[:-1]
        with jax.named_scope("ifft2"):
            return self._transform(spectra, c), last

    def _transform(self, spectra: jax.Array, c) -> jax.Array:
        """[5, N, N] spectra → [5, N, N] complex spatial fields."""
        if self.eval_mode == "direct":
            # F_c = Eᵀ @ C_c @ E — exact at any unit_width.
            ex = c["ex_re"] + 1j * c["ex_im"]
            return jnp.einsum(
                "ni,cnm,mj->cij", ex, spectra, ex,
                precision=jax.lax.Precision.HIGHEST)
        if self._has_modulation:
            spectra = spectra * (c["pre_re"] + 1j * c["pre_im"])[None]
        f = self._ifft2(spectra)
        if self._has_modulation:
            f = f * (c["post_re"] + 1j * c["post_im"])[None]
        return f

    def _extract_fields(self, f: jax.Array, c, last=None) -> OceanFields:
        return self._extract_planes(jnp.real(f), jnp.imag(f), last, c)

    def _extract_planes(self, re, im, last, c) -> OceanFields:
        """Transformed channel planes → OceanFields. Packed fields alternate
        Re/Im down the packed channel list (evolve.packed_coefficients);
        ``last`` is the half-spectrum route's real plane for the final
        packed field (None when that channel rode the full transform)."""
        nch5 = self._nch == 5
        if self.pack_channels:
            if last is not None:
                return self._extract_fields_planes(
                    re[0], im[0], re[1] if nch5 else last,
                    im[1] if nch5 else None, last if nch5 else None, c)
            return self._extract_fields_planes(
                re[0], im[0], re[1], im[1] if nch5 else None,
                re[2] if nch5 else None, c)
        return self._extract_fields_planes(
            re[0], im[1], im[2], im[3] if nch5 else None,
            im[4] if nch5 else None, c)

    def _extract_fields_planes(self, height, disp_x, disp_z,
                               slope_x, slope_z, c) -> OceanFields:
        cfg = self.cfg
        chop = cfg.choppiness

        if cfg.normals_mode == "spectral":
            normal = field_ops.normals_spectral(slope_x, slope_z)
            if cfg.spectrum_layout == "centered":
                foam, jac = field_ops.whitecap_oracle(disp_x, disp_z, normal)
            else:
                foam, jac = field_ops.whitecap_gpu(chop * disp_x,
                                                   chop * disp_z, normal)
        else:
            texel_size = cfg.length / cfg.resolution
            normal = field_ops.normals_stencil(
                chop * disp_x, height, chop * disp_z, texel_size)
            if cfg.spectrum_layout == "centered":
                foam, jac = field_ops.whitecap_oracle(disp_x, disp_z, normal)
            else:
                foam, jac = field_ops.whitecap_gpu(chop * disp_x,
                                                   chop * disp_z, normal)

        return OceanFields(
            height=height,
            disp_x=disp_x,
            disp_z=disp_z,
            pos_x=c["x0"] - chop * disp_x,
            pos_z=c["z0"] - chop * disp_z,
            normal=normal,
            foam=foam,
            jacobian=jac,
        )
