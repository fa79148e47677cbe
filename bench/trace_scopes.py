"""Device time of the step's named scopes, from one jax.profiler trace.

    python bench/trace_scopes.py [--res 1024] [--steps 20] [--out DIR]

Traces ``--steps`` shipping steps (solver.PRODUCTION) after a warm-up,
reads the trace with jax.profiler.ProfileData, and attributes every device
event to the solver's named scopes (dispersion, spectrum_assembly, ifft2,
ifft2_half, fields). XLA fuses across scopes — the assembly runs inside the
fusion that feeds cuFFT — so a kernel's scopes are read from the compiled
HLO: the op_name metadata of every instruction inside its fusion. A kernel
that mixes scopes is reported under all of them joined by "+"; "other" has
none. Prints one JSON line: per scope set the device milliseconds per step,
for the assembly and fields sets their byte model and share of the card's
HBM roofline (benchlib.PEAKS), the device-busy and idle shares of the traced
window, and the card. The raw per-kernel table goes to
``<out>/trace_events_<res>.json``.
"""

from __future__ import annotations


# repo-root import bootstrap: these scripts run directly from a checkout
# (sys.path[0] is the script's own dir, not the repo root)
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import glob
import json
import os
import re
import sys
import tempfile

SCOPES = ("spectrum_assembly", "ifft2_half", "ifft2", "fields", "dispersion")


def scope_bytes(n: int, packed_channels: int = 2) -> dict:
    """Least HBM bytes per step of each scope (f32 [N, N] planes):
    dispersion reads phase + omega and writes phase; spectrum_assembly reads
    4 h0 planes, the phase and 2·P coefficient planes and writes P complex
    spectra (the half channel only N/2+1 rows); fields reads 3 transform
    planes + the x0/z0 grids and writes normal (3), foam, jacobian, pos_x
    and pos_z."""
    p = packed_channels
    plane = n * n * 4.0
    return {"dispersion": 3 * plane,
            "spectrum_assembly": (5 + 2 * p) * plane
            + 2 * (p - 0.5) * plane,
            "fields": (5 + 7) * plane}


def scopes_in(op_name: str) -> set:
    """Solver scopes named in one op_name path."""
    parts = op_name.split("/")
    return {sc for sc in SCOPES if sc in parts}


def fusion_scopes(hlo_text: str) -> dict:
    """{kernel name: frozenset of scopes} for every fusion of a compiled
    HLO module: the scopes of the fusion's own metadata and of every
    instruction in the computations it calls (recursively). Kernel names
    are the instruction names with '.' → '_' (as the profiler shows them)."""
    comps, cur = {}, None
    head = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s.*\{\s*$")
    instr = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=")
    for line in hlo_text.splitlines():
        m = head.match(line)
        if m:
            cur = comps.setdefault(m.group(1), {"ops": set(), "calls": [],
                                                "fusions": {}})
            continue
        if cur is None:
            continue
        m = instr.match(line)
        if not m:
            continue
        names = re.findall(r'op_name="([^"]*)"', line)
        own = set().union(*(scopes_in(n) for n in names)) if names else set()
        cur["ops"] |= own
        called = re.findall(r"(?:calls|to_apply)=%([\w.\-]+)", line)
        cur["calls"] += called
        if " fusion(" in line:
            cur["fusions"][m.group(1)] = (own, called)

    def deep(c, seen=()):
        if c not in comps or c in seen:
            return set()
        out = set(comps[c]["ops"])
        for d in comps[c]["calls"]:
            out |= deep(d, seen + (c,))
        return out

    result = {}
    for comp in comps.values():
        for name, (own, called) in comp["fusions"].items():
            sc = set(own)
            for c in called:
                sc |= deep(c)
            result[name.replace(".", "_")] = frozenset(sc)
    return result


def scope_key(scopes) -> str:
    return "+".join(sorted(scopes)) if scopes else "other"


def reduce_trace(path: str) -> dict:
    """Per-kernel totals of the device planes of one .xplane.pb."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    kernels, spans = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {str(k): str(v) for k, v in ev.stats}
                key = ev.name
                rec = kernels.setdefault(key, {"name": ev.name, "count": 0,
                                               "total_ns": 0.0,
                                               "line": line.name,
                                               "stats": stats})
                rec["count"] += 1
                rec["total_ns"] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns,
                              line.name))
    return {"kernels": kernels, "spans": spans}


def busy_ns(spans) -> float:
    """Union length of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((s, e) for s, e, _ in spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", type=str, default="chiprun_out")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from tpu_ocean.benchlib import card_info, enable_compile_cache, peaks_for
    from tpu_ocean.config import OCEAN_DEMO
    from tpu_ocean.solver import OceanSolver, PRODUCTION

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("trace_scopes.py: no GPU; device times come from a GPU run "
              "only", file=sys.stderr)
        return 2
    peaks = peaks_for(dev)
    enable_compile_cache()
    n = args.res
    solver = OceanSolver(OCEAN_DEMO.replace(resolution=n, length=float(n)),
                         **PRODUCTION)
    state = solver.init(jax.random.PRNGKey(0))
    dt = jnp.float32(1.0 / 60.0)
    hlo = fusion_scopes(solver._step_jit.lower(
        state, dt, solver._consts).compile().as_text())
    for _ in range(3):                                     # compile + warm
        state, fields = solver.step(state, dt)
    jax.block_until_ready(fields)
    logdir = tempfile.mkdtemp(prefix="trace_scopes_")
    with jax.profiler.trace(logdir):
        for _ in range(args.steps):
            state, fields = solver.step(state, dt)
        jax.block_until_ready(fields)
    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    red = reduce_trace(path)
    spans = red["spans"]
    window = (max(e for _, e, _ in spans) - min(s for s, _, _ in spans)
              if spans else 0.0)
    per_scope = {}
    for rec in red["kernels"].values():
        # library kernels (cuFFT) carry their op's path in the 'name' stat;
        # XLA fusions are looked up in the compiled HLO
        named = scopes_in(rec["stats"].get("name", ""))
        sc = named or hlo.get(rec["name"].replace(".", "_"), frozenset())
        rec["scope"] = scope_key(sc)
        per_scope[rec["scope"]] = (per_scope.get(rec["scope"], 0.0)
                                   + rec["total_ns"])
    model = scope_bytes(n)
    scopes = {}
    for key, ns in sorted(per_scope.items()):
        ms = ns / args.steps / 1e6
        entry = {"device_ms_per_step": ms}
        scopes[key] = entry
    # byte rooflines of the assembly and the stencils: every kernel that
    # carries the scope counts toward it (the assembly shares its kernel
    # with the FFT input packing)
    rooflines = {}
    for name in ("spectrum_assembly", "fields", "dispersion"):
        ms = sum(v["device_ms_per_step"] for k, v in scopes.items()
                 if name in k.split("+"))
        least_ms = model[name] / peaks["hbm_bytes_per_s"] * 1e3
        rooflines[name] = {"device_ms_per_step": ms,
                           "model_mb": model[name] / 1e6,
                           "roofline_ms": least_ms,
                           "x_roofline": ms / least_ms}
    busy = busy_ns(spans)
    out = {"res": n, "steps": args.steps, "variant": "shipping",
           "scopes": scopes, "rooflines": rooflines,
           "device_busy_ms_per_step": busy / args.steps / 1e6,
           "window_ms": window / 1e6,
           "idle_share": 1.0 - busy / window if window else None,
           "device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "card": card_info(), "peaks_source": peaks["source"]}
    os.makedirs(args.out, exist_ok=True)
    table = sorted(red["kernels"].values(), key=lambda r: -r["total_ns"])
    with open(os.path.join(args.out, f"trace_events_{n}.json"), "w") as f:
        json.dump(table, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
