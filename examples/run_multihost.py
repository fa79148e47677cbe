"""Multi-host domain-decomposed ocean run (see docs/multihost.md).

Run the SAME script on every host, naming the coordinator and each rank:

    python examples/run_multihost.py --res 4096 --steps 600 \
        --coordinator host0:12345 --num-processes 2 --process-id $RANK

Single process (no --coordinator): it runs on whatever local devices exist
(the cards of one host, or the 8 fake CPU devices under
XLA_FLAGS=--xla_force_host_platform_device_count=8, which is how CI
exercises it).
"""


# repo-root import bootstrap: these scripts run directly from a checkout
# (sys.path[0] is the script's own dir, not the repo root)
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import sys

import jax

from tpu_ocean.config import OceanConfig
from tpu_ocean.parallel import initialize_distributed, make_mesh
from tpu_ocean.solver_dist import DistributedOceanSolver
from tpu_ocean.observe import Metrics
from tpu_ocean.diagnostics import energy_budget


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--backend", type=str, default="reference")
    ap.add_argument("--overlap-chunks", type=int, default=1)
    ap.add_argument("--production", action="store_true",
                    help="the shipping sharded switch set (solver."
                         "PRODUCTION): real_state + Hermitian packing + "
                         "mirror-balanced half-spectrum C2R (the a2a moves "
                         "1.5 channel-equivalents — bench/scaling_model.md)")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="host:port of process 0 (multi-host runs)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id)
    mesh = make_mesh()
    n_dev = mesh.devices.size
    is_lead = jax.process_index() == 0
    if is_lead:
        print(f"# mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} "
              f"over {n_dev} devices / {jax.process_count()} hosts",
              file=sys.stderr)

    cfg = OceanConfig(
        resolution=args.res, length=float(args.res), wind=(14.0, 12.0),
        amplitude=0.4, amplitude_scale=1e-4, choppiness=0.5,
        evolution_mode="phase", dispersion_mode="capillary",
        spectrum_layout="fft", normals_mode="stencil", damping=0.01,
        oracle_sign_quirk=False)
    kw = {}
    if args.production:
        from tpu_ocean.solver import PRODUCTION
        args.backend = "reference"
        kw = dict(PRODUCTION)
    solver = DistributedOceanSolver(cfg, mesh, fft_backend=args.backend,
                                    overlap_chunks=args.overlap_chunks, **kw)
    state = solver.init(jax.random.PRNGKey(0))

    metrics = Metrics(grid_points=args.res ** 2,
                      emit=sys.stderr if is_lead else None)
    fields = None
    for _ in range(args.steps):
        with metrics.measure():
            state, fields = solver.step(state, 1.0 / 60.0)
            jax.block_until_ready(fields.height)
    if is_lead:
        print(f"# summary: {metrics.summary()}", file=sys.stderr)
        print(f"# budget: {energy_budget(fields)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
