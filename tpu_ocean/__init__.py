"""tpu_ocean — a spectral ocean heightfield framework in JAX.

Built from scratch in JAX/XLA with the simulation capabilities of the
Mistral-Water reference (Unity C# + HLSL, see /root/reference): Phillips-spectrum
initialization, time-evolved dispersion (phase-accumulation and absolute-time),
batched 2-D inverse Stockham FFTs for height / choppy displacement / slope fields,
Jacobian-determinant whitecap detection, and a Gerstner/sinusoid wave-bank pond
solver — domain-decomposed across device meshes for large grids.

Layer map (SURVEY.md §1, re-architected as array programs):
  L1 math        -> grids.py, spectra.py          (pure jnp, stateless)
  L2 kernels     -> fft/, fields.py, gerstner.py  (jnp.fft + fused XLA loops)
  L3 host orch.  -> solver.py                     (one jitted step over a pytree)
  L4 consumers   -> viz.py, observe.py            (exporters / diagnostics)
  L5 config      -> config.py                     (frozen dataclasses + presets)
Oracle           -> oracle.py                     (numpy port of FFTMesh.cs)
Parallel         -> parallel/, fft/distributed.py (mesh, all_to_all, halo rings)
"""

from tpu_ocean.config import (
    OceanConfig,
    PondConfig,
    OCEAN_DEMO,
    FFT_MESH_DEMO,
    POND_DEMO,
)
from tpu_ocean.solver import OceanState, OceanFields, OceanSolver
from tpu_ocean.gerstner import PondSolver, WaveBank
from tpu_ocean.runtime import Simulation, PondSimulation

__version__ = "0.1.0"

__all__ = [
    "OceanConfig",
    "PondConfig",
    "OCEAN_DEMO",
    "FFT_MESH_DEMO",
    "POND_DEMO",
    "OceanState",
    "OceanFields",
    "OceanSolver",
    "PondSolver",
    "WaveBank",
    "Simulation",
    "PondSimulation",
]

# Heavier subsystems import lazily from their modules:
#   tpu_ocean.solver_dist.DistributedOceanSolver   (domain decomposition)
#   tpu_ocean.ensemble.EnsembleOceanSolver         (data parallel)
#   tpu_ocean.cascade.CascadeSolver                (multi-band / expert)
#   tpu_ocean.lod.LODCascadeSolver                 (per-band refresh rates)
#   tpu_ocean.serve.FrameServer / stream_frames    (real-time frame serving)
#   tpu_ocean.checkpoint / observe / viz / diagnostics / native
