"""Deterministic, seeded fault injection: the plan and its hook (port of
``keystone_tpu/faults/plan.py``).

Named :func:`fault_point` hooks sit where a long fit talks to the world
outside it (chunk production, staging copies; the serving, cluster,
compile, trainer and autoscale sites come with their modules), and a
:class:`FaultPlan`, installed in code or parsed from the
``KEYSTONE_FAULTS`` environment variable, decides which invocations of
which sites raise which typed error. With no plan installed and
``KEYSTONE_FAULTS`` unset, a fault point is one lookup that returns None.

Plan grammar (``KEYSTONE_FAULTS``)::

    plan    := clause (';' clause)*
    clause  := site ['#' match] '=' kind ['@' hits]
    kind    := 'transient' | 'fatal' | 'kill'
    hits    := index (',' index)*            # 0-based invocation indices
             | 'p' RATE ['x' LIMIT] ['s' SEED]   # seeded Bernoulli per
                                             # invocation, at most LIMIT
                                             # faults, from SEED

``site`` names a hook (the constants below). ``#match`` restricts a clause
to invocations whose ``replica=`` attribute equals ``match``; each clause
counts its own matching invocations, so indices are deterministic per
clause (the clauses of one site are tried in order, and the first that
fires ends the invocation). Without ``@hits`` a clause fires at ``@0``.

Kinds: ``transient`` raises :class:`FaultInjected` (a
:class:`TransientError`, what the retry budget recovers from); ``fatal``
raises :class:`FatalFaultInjected` (never retried: how a fit is killed so
that its resume can be tested); ``kill`` raises :class:`ReplicaKilled`, a
``BaseException`` that passes through ``except Exception`` as a dying
thread would.

Examples::

    KEYSTONE_FAULTS="scan.chunk=transient@2,5"       # chunk pulls 2 and 5 fault once each
    KEYSTONE_FAULTS="scan.stage=transient@p0.2x3s7"  # ~20 % of copies, at most 3, seed 7
    KEYSTONE_FAULTS="scan.chunk=fatal@8"             # kill the scan at its 9th pull
"""

from __future__ import annotations

import logging
import os
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# -- the sites ----------------------------------------------------------------

#: chunk production of a scan (before each pull of the chunk source)
SCAN_CHUNK = "scan.chunk"
#: the copy of a produced chunk to the scan's device
SCAN_STAGE = "scan.stage"
#: one replica micro-batch (attribute ``replica=index``)
REPLICA_BATCH = "replica.batch"
#: one read of the compiled-program cache
AOT_READ = "aot.read"
#: one cluster worker-process spawn attempt
WORKER_SPAWN = "worker.spawn"
#: one trainer-daemon tail of the append-only chunk source
TRAINER_INGEST = "trainer.ingest"
#: one chunk folded by a trainer absorb, inside the checkpointed fold
TRAINER_ABSORB = "trainer.absorb"
#: one trainer canary attempt, before the fleet swap
TRAINER_CANARY = "trainer.canary"
#: one autoscaler scale-up, after the new slot is spawned and before it is ready
SCALE_SPAWN = "scale.spawn"
#: one autoscaler scale-down, after its drain begins
SCALE_DRAIN = "scale.drain"

_KINDS = ("transient", "fatal", "kill")


# -- typed errors ---------------------------------------------------------------


class TransientError(Exception):
    """A failure worth retrying: the operation is expected to succeed if
    run again (flaky I/O, a dropped connection, an injected fault). The
    retry budget retries only errors classified transient."""


class FaultInjected(TransientError):
    """A ``transient`` fault raised by :func:`fault_point`."""

    def __init__(self, site: str, invocation: int):
        super().__init__(f"injected transient fault at {site} (invocation {invocation})")
        self.site = site
        self.invocation = invocation


class FatalFaultInjected(RuntimeError):
    """A ``fatal`` fault: never transient, never retried."""

    def __init__(self, site: str, invocation: int):
        super().__init__(f"injected fatal fault at {site} (invocation {invocation})")
        self.site = site
        self.invocation = invocation


class ReplicaDown(BaseException):
    """Base of the worker-death signals, a ``BaseException`` so that it
    passes the ``except Exception`` handlers between a loop and its
    supervisor. ``pending`` carries the requests the worker leaves
    unanswered."""

    def __init__(self, message: str):
        super().__init__(message)
        self.pending: Optional[list] = None


class ReplicaKilled(ReplicaDown):
    """A ``kill`` fault: the thread that reaches it dies there."""


def is_transient(exc: BaseException) -> bool:
    """The retry classification: :class:`TransientError` and the standard
    library's families that mean the world hiccuped, not that the program
    is wrong."""
    return isinstance(exc, (TransientError, ConnectionError, TimeoutError))


# -- the plan -----------------------------------------------------------------


@dataclass
class FaultSpec:
    """One parsed clause: which invocations of ``site`` fault, and how."""

    site: str
    kind: str
    #: 0-based matching-invocation indices (None: a seeded Bernoulli clause)
    at: Optional[frozenset] = None
    rate: float = 0.0
    limit: Optional[int] = None
    seed: int = 0
    #: only invocations whose ``replica`` attribute equals this
    match: Optional[int] = None
    count: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)
    _rng: Optional[random.Random] = field(default=None, compare=False, repr=False)

    def reset(self) -> None:
        self.count = 0
        self.fired = 0
        self._rng = None

    def _hit(self) -> bool:
        i = self.count
        self.count += 1
        if self.at is not None:
            if i in self.at:
                self.fired += 1
                return True
            return False
        if self.limit is not None and self.fired >= self.limit:
            return False
        if self._rng is None:
            self._rng = random.Random(self.seed)
        if self._rng.random() < self.rate:
            self.fired += 1
            return True
        return False


class FaultPlan:
    """A parsed fault schedule, safe across threads: each clause counts its
    own matching invocations, so concurrent callers see one deterministic
    schedule."""

    def __init__(self, specs: List[FaultSpec]):
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in specs:
            self._by_site.setdefault(s.site, []).append(s)
        #: faults injected at each site
        self.injected: Dict[str, int] = {}

    @property
    def sites(self) -> Tuple[str, ...]:
        return tuple(self._by_site)

    def reset(self) -> None:
        """Zero every clause's counters and seed its generator again."""
        with self._lock:
            for specs in self._by_site.values():
                for s in specs:
                    s.reset()
            self.injected.clear()

    def check(self, site: str, attrs: dict) -> Optional[str]:
        """Count one invocation of ``site``: the kind of fault to raise, or
        None. A site the plan does not name takes no lock."""
        specs = self._by_site.get(site)
        if specs is None:
            return None
        with self._lock:
            for s in specs:
                if s.match is not None and attrs.get("replica") != s.match:
                    continue
                if s._hit():
                    self.injected[site] = self.injected.get(site, 0) + 1
                    return s.kind
        return None


def parse_plan(text: str) -> FaultPlan:
    """Parse the ``KEYSTONE_FAULTS`` grammar (module docstring). A clause
    that does not parse raises ``ValueError`` naming it."""
    specs: List[FaultSpec] = []
    for clause in text.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        try:
            site_part, eq, rhs = clause.partition("=")
            if not eq or not site_part or not rhs:
                raise ValueError("expected site=kind[@hits]")
            site_part = site_part.strip()
            match: Optional[int] = None
            if "#" in site_part:
                site_part, m = site_part.split("#", 1)
                match = int(m)
            kind, _, hits = rhs.strip().partition("@")
            kind = kind.strip()
            if kind not in _KINDS:
                raise ValueError(f"unknown kind {kind!r} (use {'|'.join(_KINDS)})")
            spec = FaultSpec(site=site_part, kind=kind, match=match)
            hits = hits.strip()
            if not hits:
                spec.at = frozenset((0,))
            elif hits.startswith("p"):
                body, seed, limit = hits[1:], 0, None
                if "s" in body:
                    body, s = body.split("s", 1)
                    seed = int(s)
                if "x" in body:
                    body, x = body.split("x", 1)
                    limit = int(x)
                rate = float(body)
                if not 0.0 < rate <= 1.0:
                    raise ValueError(f"rate {rate} outside (0, 1]")
                spec.rate, spec.limit, spec.seed = rate, limit, seed
            else:
                spec.at = frozenset(int(i) for i in hits.split(","))
            specs.append(spec)
        except ValueError as e:
            raise ValueError(f"bad KEYSTONE_FAULTS clause {clause!r}: {e}") from None
    if not specs:
        raise ValueError(f"empty fault plan: {text!r}")
    return FaultPlan(specs)


# -- installation and the hook ------------------------------------------------

_installed: Optional[FaultPlan] = None
_env_plan: Optional[FaultPlan] = None
_env_raw: Optional[str] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` for the process; it wins over ``KEYSTONE_FAULTS``."""
    global _installed
    _installed = plan
    return plan


def clear() -> None:
    """Remove the installed plan and forget the parse of
    ``KEYSTONE_FAULTS``, so the next schedule starts with fresh counters."""
    global _installed, _env_plan, _env_raw
    _installed = None
    _env_plan = None
    _env_raw = None


def active_plan() -> Optional[FaultPlan]:
    """The plan in force: the installed one, else the parse of
    ``KEYSTONE_FAULTS`` (unset or blank: none), cached on the raw string so
    that its counters last as long as the value does."""
    if _installed is not None:
        return _installed
    raw = (os.environ.get("KEYSTONE_FAULTS") or "").strip()
    if not raw:
        return None
    global _env_plan, _env_raw
    if raw != _env_raw:
        _env_plan = parse_plan(raw)
        _env_raw = raw
        logger.warning("fault injection ACTIVE: KEYSTONE_FAULTS=%r (sites: %s)", raw,
                       ", ".join(_env_plan.sites))
    return _env_plan


def fault_point(site: str, **attrs) -> None:
    """The hook: nothing without a plan; with one, records a
    ``fault.inject`` instant (in the flight ring and, when tracing, the
    tracer) and raises the scheduled typed error for this invocation of
    ``site``. ``attrs`` is the matching context (``replica=index``) and
    goes on the instant."""
    plan = active_plan()
    if plan is None:
        return
    kind = plan.check(site, attrs)
    if kind is None:
        return
    invocation = plan.injected.get(site, 1) - 1
    logger.warning("fault injected: site=%s kind=%s attrs=%s", site, kind, attrs)
    try:
        from ..obs import flight
        from ..obs.tracer import current as _trace_current

        # every injection goes into the always-on flight ring, so that a
        # post-mortem dump shows the plan's hits with tracing off
        flight.record_instant("fault.inject", site=site, kind=kind, **attrs)
        tracer = _trace_current()
        if tracer is not None:
            tracer.instant("fault.inject", op_type="FaultPlan", site=site, kind=kind, **attrs)
    except Exception:
        # recording must never change what the fault does
        logger.debug("fault.inject instant not recorded", exc_info=True)
    if kind == "kill":
        raise ReplicaKilled(f"injected kill at {site}")
    if kind == "fatal":
        raise FatalFaultInjected(site, invocation)
    raise FaultInjected(site, invocation)
