"""Multi-host fault injection (SURVEY.md §5.3, ROADMAP.md):

two REAL processes run the domain-decomposed solver with per-step
checkpointing; one process is killed mid-run; the supervisor (this test)
tears down the survivor and relaunches the fleet with --resume; the resumed
trajectory must finish with exactly the checksum of an uninterrupted run.
"""

import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1]); port = sys.argv[2]
    ckpt = sys.argv[3]; total = int(sys.argv[4])
    die_at = int(sys.argv[5])         # -1 = never
    jax.distributed.initialize(f"localhost:{port}", 2, pid)
    import numpy as np, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver_dist import DistributedOceanSolver
    from tpu_ocean.checkpoint import save_checkpoint, load_checkpoint

    devs = np.asarray(jax.devices()).reshape(1, -1)
    mesh = Mesh(devs, ("batch", "shard"))
    # the PRODUCTION switch set (r5): all-real state, Hermitian packing,
    # mirror-balanced half-spectrum, fused fields — fault tolerance is
    # claimed for the pipeline that actually ships, not a reference twin
    cfg = OceanConfig(resolution=128, length=128.0, wind=(6.0, 4.0),
                      amplitude=0.1, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    solver = DistributedOceanSolver(cfg, mesh,
                                    real_state=True, pack_channels=True,
                                    half_spectrum=True)

    rep = NamedSharding(mesh, P())
    gather = jax.jit(lambda x: x, out_shardings=rep)

    start = 0
    if os.path.exists(ckpt):
        # every process loads the same full-state npz and re-shards it
        # (the all-real wire format: h0 as re/im planes)
        full, _ = load_checkpoint(ckpt)
        if hasattr(full, "h0_re"):      # all-real wire representation
            h0 = np.asarray(full.h0_re) + 1j * np.asarray(full.h0_im)
            h0c = np.asarray(full.h0c_re) + 1j * np.asarray(full.h0c_im)
        else:                           # unified loader surfaced complex
            h0 = np.asarray(full.h0)
            h0c = np.asarray(full.h0_conj)
        st = solver.init(h0=h0, h0_conj=h0c)
        x_sh = NamedSharding(mesh, P("shard", None))
        z_sh = NamedSharding(mesh, P(None, "shard"))
        st = st._replace(
            phase=jax.device_put(np.asarray(full.phase), x_sh),
            t=jax.device_put(np.asarray(full.t), rep),
            step=jax.device_put(np.asarray(full.step), rep),
            foam_accum=jax.device_put(np.asarray(full.foam_accum), z_sh))
        start = int(np.asarray(full.step))
    else:
        st = solver.init(jax.random.PRNGKey(7))
    st = solver.symmetrize(st)          # packed route projection

    for k in range(start, total):
        st, f = solver.step(st, 1 / 60)
        jax.block_until_ready(f.height)
        # gather-to-replicated so every process can host-read the state,
        # then process 0 persists it (the supervisor's resume source)
        rep_state = st._replace(
            h0_re=gather(st.h0_re), h0_im=gather(st.h0_im),
            h0c_re=gather(st.h0c_re), h0c_im=gather(st.h0c_im),
            phase=gather(st.phase), foam_accum=gather(st.foam_accum))
        if pid == 0:
            save_checkpoint(ckpt, rep_state, cfg)
        print(f"STEP {k + 1}", flush=True)
        if pid == 1 and die_at >= 0 and k + 1 == die_at:
            os._exit(17)              # simulated host failure

    s = float(jnp.sum(jnp.abs(gather(f.height))))
    print(f"CHECKSUM {s:.6f}", flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(ckpt, total, die_at):
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), port, ckpt, str(total),
         str(die_at)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT) for i in range(2)]


def _finish(procs, timeout=240):
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        outs.append((p.returncode, out, err))
    return outs


def test_kill_one_host_restart_fleet_resume(tmp_path):
    ckpt = str(tmp_path / "fleet.npz")
    total = 8

    # ground truth: uninterrupted 2-process run
    truth = _finish(_launch(str(tmp_path / "truth.npz"), total, -1))
    assert all(rc == 0 for rc, _, _ in truth), truth[0][2][-800:]
    want = [l.split()[1] for rc, o, _ in truth for l in o.splitlines()
            if l.startswith("CHECKSUM")][0]

    # run 1: process 1 dies after step 4; supervisor kills the survivor
    procs = _launch(ckpt, total, die_at=4)
    rc1 = procs[1].wait(timeout=240)
    assert rc1 == 17, "worker 1 should have simulated a crash"
    time.sleep(1.0)
    procs[0].send_signal(signal.SIGKILL)   # supervisor tears down the fleet
    procs[0].wait(timeout=60)
    assert os.path.exists(ckpt), "no checkpoint survived the crash"

    # run 2: relaunch the fleet; it must RESUME (not restart) and match
    redo = _finish(_launch(ckpt, total, -1))
    assert all(rc == 0 for rc, _, _ in redo), redo[0][2][-800:]
    out0 = redo[0][1]
    steps = [int(l.split()[1]) for l in out0.splitlines()
             if l.startswith("STEP")]
    assert steps and steps[0] > 1, f"fleet restarted from scratch: {steps[:2]}"
    got = [l.split()[1] for rc, o, _ in redo for l in o.splitlines()
           if l.startswith("CHECKSUM")][0]
    assert got == want, f"resumed trajectory diverged: {got} != {want}"
