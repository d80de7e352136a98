"""Deterministic fault injection for the control plane.

A copy of ``mapreduce_rust_tpu/analysis/chaos.py`` (stdlib only): a
fault fires in the port at the same site it fires in the reference.

Every recovery path this framework ships — lease expiry, re-execution,
idempotent finishes, speculative attempts, revocation, the late-report
path — used to be tested by timing luck: a test killed a worker and hoped
the kill landed inside the window it meant to exercise. This module makes
faults first-class: a **spec string** names seeded, reproducible faults at
named worker sites, carried by ``Config.chaos`` / ``MR_CHAOS=<spec>`` /
``run|worker --chaos``.

Spec grammar (elements separated by ``;``)::

    spec  := elem (';' elem)*
    elem  := 'seed=' INT | fault
    fault := SITE ':' ARG (':' ARG)*

Sites and their positional args (PHASE is ``map``/``reduce``/``*``; TID is
an int or ``*``; SECONDS a float)::

    pause:PHASE:TID:SECONDS      sleep before sending the finish report —
                                 the slow-but-ALIVE straggler (renewals
                                 keep flowing; only speculation or
                                 patience recovers this one)
    kill:PHASE:TID               SIGKILL this process mid-task (lease
                                 expiry + re-execution recovers)
    drop_finish:PHASE:TID        suppress the finish-report RPC (the task
                                 completed; the coordinator never hears —
                                 lease expiry re-executes, the journal
                                 dedups)
    delay_finish:PHASE:TID:SECONDS  delay the finish-report RPC (late-
                                 report race against the lease detector)
    wedge_renewal:PHASE:TID      stop heartbeats for the attempt while the
                                 task keeps computing (wedged renewal
                                 thread: lease expires under a live task)
    slow_scan:wWID:SECONDS       worker WID computes SECONDS slower per
                                 task (the heterogeneous-fleet straggler
                                 the doctor flags and speculation beats)
    slow_disk:SECONDS            every spill-run write sleeps SECONDS
                                 first (runtime/spill.py — one checkpoint
                                 covers dictionary AND accumulator tiers;
                                 ``p=`` samples runs by seeded hash of the
                                 run index). The slow-disk straggler the
                                 ASYNC spill writer hides behind compute
                                 while the sync plane stalls per run —
                                 bench.py --chaos measures exactly that
                                 pair
    slow_dispatch:SECONDS        every device-merge dispatch sleeps
                                 SECONDS first (runtime/driver.py — ONE
                                 checkpoint in the dispatch plane, firing
                                 per packed merge; ``p=`` samples by
                                 seeded hash of the dispatch index). The
                                 slow-device-hop straggler the ASYNC
                                 dispatch plane hides on its own thread
                                 while --sync-dispatch eats every delay
                                 on the router's wall — bench.py --chaos
                                 measures exactly that pair

Trailing ``KEY=VAL`` args refine any fault: ``attempt=N`` (default 1 —
a fault that re-fired on the recovery attempt would loop forever; ``*``
matches every attempt) and ``p=P`` (with ``tid=*``: fire on the fraction P
of tasks, chosen by a **seeded hash** of (seed, site, phase, tid, attempt)
so the same seed always picks the same victims).

Pure stdlib, no jax — importable from any control-plane process.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

SITES = (
    "pause", "kill", "drop_finish", "delay_finish", "wedge_renewal",
    "slow_scan", "slow_disk", "slow_dispatch",
)
_NEEDS_SECONDS = ("pause", "delay_finish", "slow_scan", "slow_disk",
                  "slow_dispatch")

#: Canonical scenario specs shared by ``bench.py --chaos`` and the chaos
#: test suite — one copy, so the benched and the tested faults are the
#: same faults. Keyed by scenario name; every spec is seeded. The
#: wedge_renewal scenario pairs the wedge with a pause: a task that
#: finishes inside its lease would make the dead heartbeat unobservable —
#: the pause keeps the task alive past expiry, so the recovery under test
#: (lease expiry beneath a LIVE task + its late report) actually runs.
SCENARIOS: dict[str, str] = {
    "pause": "seed=1;pause:map:0:1.2",
    "kill": "seed=2;kill:map:1",
    "drop_finish": "seed=3;drop_finish:reduce:0",
    "wedge_renewal": "seed=4;wedge_renewal:map:0;pause:map:0:3.0",
    "slow_scan": "seed=5;slow_scan:w0:2.5",
    # Fires only where a spill tier engages (the cluster legs run
    # unbudgeted, so there it is a fault-free control); the bench's
    # dedicated --chaos slow-disk pair runs it against a BUDGETED job,
    # async vs sync, to measure what the background writer hides.
    "slow_disk": "seed=6;slow_disk:0.05",
    # Fires on every packed device merge the host engine dispatches
    # (cluster workers run map_engine='host'); the bench's dedicated
    # --chaos slow-dispatch pair runs it async-vs-sync against a real
    # window stream to measure what the dispatch thread hides.
    "slow_dispatch": "seed=7;slow_dispatch:0.02",
}


@dataclasses.dataclass
class Fault:
    site: str
    phase: str | None = None   # "map" | "reduce" | None (= "*")
    tid: int | None = None     # None = "*"
    wid: int | None = None     # slow_scan target
    seconds: float = 0.0
    attempt: int | None = 1    # None = every attempt
    p: float | None = None     # seeded sampling fraction (tid=* only)

    def matches(self, seed: int, site: str, phase=None, tid=None,
                attempt=None, wid=None) -> bool:
        if site != self.site:
            return False
        if self.phase is not None and phase != self.phase:
            return False
        if self.tid is not None and tid != self.tid:
            return False
        if self.wid is not None and wid != self.wid:
            return False
        if self.attempt is not None and attempt is not None \
                and attempt != self.attempt:
            return False
        if self.p is not None:
            # Seeded hash, not random(): the same (seed, site, phase, tid,
            # attempt) always decides the same way — reruns reproduce.
            h = hashlib.sha256(
                f"{seed}:{site}:{phase}:{tid}:{attempt}".encode()
            ).digest()
            if int.from_bytes(h[:8], "big") / 2**64 >= self.p:
                return False
        return True


class ChaosPlan:
    """A parsed spec: ``pick()`` is the single injection checkpoint the
    worker calls at each site; it returns the matching :class:`Fault` (or
    None) and records every trigger so the run manifest can list exactly
    which faults fired."""

    def __init__(self, seed: int, faults: list[Fault], spec: str) -> None:
        self.seed = seed
        self.faults = faults
        self.spec = spec
        self.events: list[dict] = []

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        seed = 0
        faults: list[Fault] = []
        for raw in spec.split(";"):
            elem = raw.strip()
            if not elem:
                continue
            if elem.startswith("seed="):
                try:
                    seed = int(elem[5:])
                except ValueError:
                    raise ValueError(f"chaos: bad seed in {elem!r}") from None
                continue
            parts = elem.split(":")
            site = parts[0]
            if site not in SITES:
                raise ValueError(
                    f"chaos: unknown site {site!r} (sites: {', '.join(SITES)})"
                )
            pos: list[str] = []
            kw: dict[str, str] = {}
            for a in parts[1:]:
                if "=" in a:
                    k, v = a.split("=", 1)
                    kw[k] = v
                else:
                    if kw:
                        raise ValueError(
                            f"chaos: positional arg after key=val in {elem!r}"
                        )
                    pos.append(a)
            faults.append(cls._build(site, pos, kw, elem))
        if not faults:
            raise ValueError(f"chaos: no faults in spec {spec!r}")
        return cls(seed, faults, spec)

    @staticmethod
    def _build(site: str, pos: list[str], kw: dict, elem: str) -> Fault:
        def bad(msg: str) -> ValueError:
            return ValueError(f"chaos: {msg} in {elem!r}")

        f = Fault(site=site)
        try:
            if site == "slow_scan":
                if len(pos) != 2 or not pos[0].startswith("w"):
                    raise bad("slow_scan needs wWID:SECONDS")
                f.wid = int(pos[0][1:])
                f.seconds = float(pos[1])
                f.attempt = None  # a slow worker is slow on EVERY attempt
            elif site in ("slow_disk", "slow_dispatch"):
                if len(pos) != 1:
                    raise bad(f"{site} needs SECONDS")
                f.seconds = float(pos[0])
                f.attempt = None  # a slow disk/device hop is slow on
                # EVERY run write / merge dispatch
            else:
                want = 3 if site in _NEEDS_SECONDS else 2
                if len(pos) != want:
                    raise bad(f"{site} needs {want} positional args")
                if pos[0] not in ("map", "reduce", "*"):
                    raise bad(f"bad phase {pos[0]!r}")
                f.phase = None if pos[0] == "*" else pos[0]
                f.tid = None if pos[1] == "*" else int(pos[1])
                if site in _NEEDS_SECONDS:
                    f.seconds = float(pos[2])
        except ValueError as e:
            if str(e).startswith("chaos:"):
                raise
            raise bad(f"bad number ({e})") from None
        for k, v in kw.items():
            try:
                if k == "attempt":
                    f.attempt = None if v == "*" else int(v)
                elif k == "p":
                    f.p = float(v)
                    if not 0.0 < f.p <= 1.0:
                        raise bad("p must be in (0, 1]")
                else:
                    raise bad(f"unknown key {k!r}")
            except ValueError as e:
                if str(e).startswith("chaos:"):
                    raise
                raise bad(f"bad number for {k}= ({e})") from None
        if f.seconds < 0:
            raise bad("seconds must be >= 0")
        return f

    @classmethod
    def from_config(cls, cfg) -> "ChaosPlan | None":
        """The worker's entry point: MR_CHAOS (process-tree enablement,
        like MR_SANITIZE) beats Config.chaos; None when neither is set."""
        spec = os.environ.get("MR_CHAOS") or getattr(cfg, "chaos", None)
        return cls.parse(spec) if spec else None

    def pick(self, site: str, phase=None, tid=None, attempt=None,
             wid=None) -> "Fault | None":
        for f in self.faults:
            if f.matches(self.seed, site, phase=phase, tid=tid,
                         attempt=attempt, wid=wid):
                self.events.append({
                    "site": site, "phase": phase, "tid": tid,
                    "attempt": attempt, "wid": wid,
                    "seconds": f.seconds or None,
                })
                return f
        return None

    def fired(self) -> list[dict]:
        """Every fault that actually triggered, in order — the manifest's
        honest record of what this run was subjected to."""
        return list(self.events)


def build_spec(seed: int, faults: "list[str]") -> str:
    """Render fault elements into one canonical seeded spec — the export
    side of the grammar (mrmodel's counterexample → chaos repro). The
    result is round-tripped through :meth:`ChaosPlan.parse` before it is
    returned: a malformed export is a bug in the exporter, and it fails
    HERE, not in the worker that later replays the repro."""
    elems: list[str] = []
    for f in faults:
        f = f.strip()
        if f and f not in elems:
            elems.append(f)
    if not elems:
        raise ValueError("chaos: build_spec needs at least one fault")
    spec = ";".join([f"seed={int(seed)}"] + elems)
    ChaosPlan.parse(spec)
    return spec
