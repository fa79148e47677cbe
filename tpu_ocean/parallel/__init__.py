"""Distributed runtime: device meshes, halo rings, distributed FFT transpose.

The reference is single-GPU/single-process — its only "transport" is texture
binding between fragment passes (OceanRenderer.cs:212-261). The device-mesh
equivalents (SURVEY.md §2.3, §5.7-5.8):

  D1  backend      — jax.distributed + jax.sharding.Mesh
  D2  data par.    — ensemble batch axis, trivially sharded leading dim
  D5  domain decomp— rows sharded; 2-D FFT = local row FFTs → all_to_all
                     transpose → local column FFTs (the Ulysses analogue)
  D6  halo ring    — width-1 lax.ppermute ring for the normal/whitecap
                     stencils; periodic boundary = ring wraparound
"""

from tpu_ocean.parallel.mesh import make_mesh, initialize_distributed
from tpu_ocean.parallel.halo import roll_sharded
from tpu_ocean.parallel.gspmd import make_gspmd_step

__all__ = ["make_mesh", "initialize_distributed", "roll_sharded",
           "make_gspmd_step"]
