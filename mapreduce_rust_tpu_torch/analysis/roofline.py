"""Roofline attribution for the data plane.

A copy of ``mapreduce_rust_tpu/analysis/roofline.py`` whose device probe
reads ``torch.cuda`` in place of a jax backend.

The methodology of the Xeon Phi MapReduce study (arXiv:1309.0215,
PAPERS.md): before optimizing a stage, place it against the machine's
roofs — how many bytes it actually moved per second vs what the hardware
can move, and how many flops per byte it performs (operational
intensity). "The scan is slow" becomes "the scan runs at 38 % of the
host memcpy roof, so a device-resident map projects ~N×".

Three parts:

- **Calibration** (``calibrate`` / ``load_machine``): machine peaks
  measured once into ``.bench/machine.json`` — a host memcpy-bandwidth
  micro-probe (bytearray slice copy, best-of-N), plus device peaks from
  ``torch.cuda`` device names **only** when torch is already imported
  and CUDA already initialized in this process (the ``platform_info``
  guard — this module must never create a CUDA context; it is imported
  by torch-free CLI tools).
- **Attribution** (``roofline_report``): per-stage achieved GB/s and
  achieved-vs-roof fractions derived from bytes the stack already
  tracks — ``bytes_in`` over the host-map scan seconds, ``spill_split``
  bytes over writer seconds, dispatch record bytes (the packed
  ``1 + 3·cap`` uint32 layout) over dispatch-thread seconds, a2a wire
  bytes over collective seconds — plus, when a manifest carries a
  ``merge_cost`` block (the reference driver's compiled-merge cost
  analysis; the port's driver writes none yet), device-merge intensity.
- **CLI** (``run_cli``): the torch-free ``prof`` subcommand — render a
  manifest's ``stats.profile``, export its collapsed stacks as a
  ``.folded`` file, and with ``--roofline`` attach the attribution.

Everything here is stdlib-only at module level.
"""

from __future__ import annotations

import json
import logging
import os
import time

log = logging.getLogger("mr.roofline")

MACHINE_SCHEMA = 1
DEFAULT_MACHINE_PATH = os.path.join(".bench", "machine.json")

# Published peak specs per device kind (HBM GB/s, dense bf16 TFLOP/s) —
# the roof for device-resident stages when the backend names real
# hardware. cpu backends fall back to the measured host memcpy roof. The
# H100 row is NVIDIA's H100 SXM data sheet (3.35 TB/s, 989 TFLOP/s), keyed
# by torch.cuda.get_device_name().
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (3350.0, 989.0),
    "TPU v4": (1228.0, 275.0),
    "TPU v5 lite": (819.0, 197.0),
    "TPU v5e": (819.0, 197.0),
    "TPU v5p": (2765.0, 459.0),
    "TPU v6 lite": (1640.0, 918.0),
}


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def measure_host_memcpy_gbs(size_mb: int = 64, repeats: int = 3) -> float:
    """Best-of-N big-buffer copy: ``dst[:] = src`` over ``size_mb`` MB of
    bytearray counts one read + one write stream per byte, the classic
    STREAM-copy shape. Best-of (not mean): interference only ever slows
    a copy down, so the fastest repeat is the cleanest roof estimate."""
    n = max(int(size_mb), 1) << 20
    src = memoryview(bytearray(n))
    dst = bytearray(n)
    best_dt = float("inf")
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        dst[:] = src
        best_dt = min(best_dt, time.perf_counter() - t0)
    return round(2.0 * n / best_dt / 1e9, 3)


def probe_device_peaks() -> list:
    """Device peaks by ``torch.cuda.get_device_name`` — guarded like
    ``telemetry.platform_info``: probe ONLY a CUDA context someone else
    already created, never import torch or initialize CUDA from here."""
    import sys as _sys

    torch = _sys.modules.get("torch")
    if torch is None:
        return []
    try:
        if not torch.cuda.is_initialized():
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            kind = torch.cuda.get_device_name(i)
            peak = DEVICE_PEAKS.get(kind)
            row = {"id": i, "kind": kind, "platform": "gpu"}
            if peak is not None:
                row["hbm_gbs"], row["tflops"] = peak
            out.append(row)
        return out
    except Exception:  # device probe failed — calibration still writes
        return []


def load_machine(path: "str | None" = None) -> "dict | None":
    path = path or DEFAULT_MACHINE_PATH
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(m, dict) or m.get("schema") != MACHINE_SCHEMA:
        return None
    return m


def calibrate(path: "str | None" = None, force: bool = False,
              size_mb: int = 64, persist: bool = True) -> dict:
    """Load the cached calibration, or measure and (optionally) write it.
    The cache is the point: peaks are a property of the machine, not the
    run, so every bench round and doctor invocation reuses one probe."""
    path = path or DEFAULT_MACHINE_PATH
    if not force:
        m = load_machine(path)
        if m is not None:
            return m
    m = {
        "schema": MACHINE_SCHEMA,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "host_memcpy_gbs": measure_host_memcpy_gbs(size_mb=size_mb),
        "probe_mb": int(size_mb),
        "devices": probe_device_peaks(),
    }
    if persist:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(m, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    return m


def device_roof_gbs(machine: dict) -> "float | None":
    """Best known device HBM roof in the calibration, if any."""
    roofs = [d.get("hbm_gbs") for d in machine.get("devices") or []
             if isinstance(d.get("hbm_gbs"), (int, float))]
    return max(roofs) if roofs else None


# ---------------------------------------------------------------------------
# Attribution
# ---------------------------------------------------------------------------

def _row(stage: str, nbytes, seconds, roof_gbs, **extra) -> "dict | None":
    if not nbytes or not seconds or seconds <= 0:
        return None
    achieved = nbytes / seconds / 1e9
    row = {
        "stage": stage,
        "bytes": int(nbytes),
        "seconds": round(float(seconds), 6),
        "achieved_gbs": round(achieved, 3),
        "roof_gbs": round(roof_gbs, 3) if roof_gbs else None,
        "frac": round(achieved / roof_gbs, 4) if roof_gbs else None,
    }
    row.update(extra)
    return row


def stage_rows(manifest: dict, machine: dict) -> list:
    """Achieved-vs-roof per stage from bytes the stack already tracks.
    Seconds are PLANE-thread seconds (aggregate across that plane's
    threads), so achieved GB/s is a per-thread rate comparable against
    the single-stream memcpy roof."""
    stats = manifest.get("stats") or {}
    cfgd = manifest.get("config") or {}
    host_roof = machine.get("host_memcpy_gbs")
    rows = []

    hms = stats.get("host_map_split") or {}
    scan_s = hms.get("scan_s") or stats.get("host_map_s")
    rows.append(_row(
        "host-map-scan", stats.get("bytes_in"), scan_s, host_roof,
        workers=hms.get("workers"),
        # The scan reads every input byte once and writes compact
        # (hash, count) records: intensity ~0 flops/byte — a memory
        # stage, so the memcpy roof is the honest ceiling.
        roof="host-memcpy",
    ))

    sp = stats.get("spill_split") or {}
    rows.append(_row(
        "spill-write", sp.get("bytes"), sp.get("write_s"), host_roof,
        roof="host-memcpy",  # upper bound; the disk usually caps sooner
    ))

    dsp = stats.get("dispatch_split") or {}
    cap = cfgd.get("host_update_cap")
    if dsp.get("dispatches") and cap:
        # The packed-merge layout: 1 + 3·cap uint32 words per dispatch
        # (driver.make_packed_merge_fn), shipped whole each time.
        dispatch_bytes = dsp["dispatches"] * (1 + 3 * int(cap)) * 4
        rows.append(_row(
            "dispatch", dispatch_bytes, dsp.get("dispatch_s"), host_roof,
            dispatches=dsp["dispatches"], roof="host-memcpy",
        ))
        mc = manifest.get("merge_cost") or {}
        if mc.get("bytes_accessed"):
            flops = (mc.get("flops") or 0.0) * dsp["dispatches"]
            mbytes = mc["bytes_accessed"] * dsp["dispatches"]
            # No fallback roof here: the bytes are XLA's static estimate
            # of buffer traffic, only honest against a real device HBM
            # peak — against host memcpy it fabricates >100% fractions.
            droof = device_roof_gbs(machine)
            row = _row(
                "device-merge", mbytes, dsp.get("dispatch_s"), droof,
                roof="device-hbm" if droof else None,
            )
            if row is not None:
                row["flops"] = flops
                row["intensity_flops_per_byte"] = round(flops / mbytes, 4)
                rows.append(row)

    ici = stats.get("ici_split") or {}
    rows.append(_row(
        "a2a-shuffle", ici.get("wire_bytes"), ici.get("all_to_all_s"),
        device_roof_gbs(machine),
        rounds=ici.get("rounds"),
        roof="device-hbm" if device_roof_gbs(machine) else None,
    ))

    return [r for r in rows if r is not None]


def roofline_report(manifest: dict, machine: dict) -> dict:
    """The full attribution document. ``scan_achieved_gbs`` and
    ``roofline_frac`` (the host-map scan's achieved-vs-roof) are the two
    headline series bench history records and the doctor trend watches —
    both bad when they go down."""
    rows = stage_rows(manifest, machine)
    scan = next((r for r in rows if r["stage"] == "host-map-scan"), None)
    doc = {
        "machine": {
            "host_memcpy_gbs": machine.get("host_memcpy_gbs"),
            "device_hbm_gbs": device_roof_gbs(machine),
        },
        "stages": rows,
        "scan_achieved_gbs": scan["achieved_gbs"] if scan else None,
        "roofline_frac": scan["frac"] if scan else None,
    }
    if scan and scan.get("frac"):
        droof = device_roof_gbs(machine)
        base = droof if droof else machine.get("host_memcpy_gbs")
        if base:
            # Projected device-map gain: a device-resident scan that
            # reaches half the target roof vs today's achieved host rate.
            # Deliberately conservative — the claim is headroom, not a
            # promise.
            doc["device_map_projection_x"] = round(
                0.5 * base / scan["achieved_gbs"], 2)
    return doc


# ---------------------------------------------------------------------------
# prof CLI (torch-free)
# ---------------------------------------------------------------------------

def render_text(doc: dict, verbose: bool = False) -> str:
    out = []
    prof = doc.get("profile")
    if prof:
        out.append(f"profile: {prof['samples']} samples @ {prof['hz']:g} Hz "
                   f"over {prof['wall_s']:.2f}s wall")
        planes = prof.get("planes") or {}
        total = sum(p["self_s"] for p in planes.values()) or 1.0
        out.append("  per-plane self time:")
        for name, p in sorted(planes.items(),
                              key=lambda kv: -kv[1]["self_s"]):
            out.append(f"    {name:<10} {p['self_s']:>8.2f}s "
                       f"{100.0 * p['self_s'] / total:>5.1f}%  "
                       f"({p['samples']} samples)")
        out.append("  top frames (self):")
        for fr in (prof.get("top_frames") or [])[:10]:
            out.append(f"    {fr['pct']:>5.1f}%  {fr['frame']}")
        ft = prof.get("frame_table") or {}
        if ft.get("dropped"):
            out.append(f"  note: frame table capped "
                       f"({ft['dropped']} drops at {ft['cap']} entries)")
    else:
        out.append("profile: none in manifest (run with --profile / "
                   "MR_PROFILE=1)")
    rl = doc.get("roofline")
    if rl:
        mach = rl["machine"]
        out.append(f"roofline (host memcpy roof "
                   f"{mach['host_memcpy_gbs']:g} GB/s"
                   + (f", device HBM {mach['device_hbm_gbs']:g} GB/s"
                      if mach.get("device_hbm_gbs") else "") + "):")
        for r in rl["stages"]:
            frac = f"{r['frac']:.0%} of {r['roof']}" if r.get("frac") \
                else "no roof"
            out.append(f"    {r['stage']:<14} {r['achieved_gbs']:>9.3f} GB/s "
                       f"({frac})  [{r['bytes'] / 1e6:.1f} MB / "
                       f"{r['seconds']:.3f}s]")
        if rl.get("device_map_projection_x"):
            out.append(f"    device-map projection: "
                       f"~{rl['device_map_projection_x']:g}× on host-map-scan "
                       f"at half the target roof (ROADMAP item 2)")
    if doc.get("folded"):
        out.append(f"folded: {doc['folded_lines']} stacks → {doc['folded']}")
    return "\n".join(out)


def run_cli(args) -> int:
    """``prof <manifest> [--folded OUT] [--roofline] [--machine PATH]
    [--format json|text]`` — torch-free like the other analysis commands."""
    try:
        with open(args.manifest) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        print(f"prof: cannot read manifest {args.manifest}: {e}")
        return 2
    stats = manifest.get("stats") or {}
    profile = stats.get("profile")
    # Flight-recorder partials carry the profile at the top level (the
    # metrics pattern): accept them too, so a SIGKILLed run's flamegraph
    # is one `prof trace.partial.json --folded out.folded` away.
    if profile is None and isinstance(manifest.get("profile"), dict):
        profile = manifest["profile"]
    doc: dict = {"manifest": os.path.abspath(args.manifest),
                 "profile": profile}

    folded_out = getattr(args, "folded", None)
    if folded_out:
        stacks = (profile or {}).get("stacks") or []
        if not stacks:
            print("prof: manifest has no profile stacks to export "
                  "(run with --profile / MR_PROFILE=1)")
            return 2
        d = os.path.dirname(os.path.abspath(folded_out))
        os.makedirs(d, exist_ok=True)
        with open(folded_out, "w") as f:
            f.write("\n".join(stacks) + "\n")
        doc["folded"] = os.path.abspath(folded_out)
        doc["folded_lines"] = len(stacks)

    if getattr(args, "roofline", False):
        machine = calibrate(getattr(args, "machine", None))
        doc["roofline"] = roofline_report(manifest, machine)

    if getattr(args, "format", "text") == "json":
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print(render_text(doc, verbose=getattr(args, "verbose", False)))
    return 0
