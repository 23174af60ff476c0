"""Worker/function state tracking (paper §IV).

The aAPP-based load balancer keeps two lookup tables:

* ``activeFunctions``  — worker id -> the function instances currently allocated
  on it (with their tags and memory), used by ``valid()`` to check
  (anti-)affinity and capacity;
* ``activeTagActivations`` — activation id -> (function, tag, worker), used to
  remove the right instance when a completion notification arrives (instances of
  the same function definition are indistinguishable by name alone).

``ClusterState`` owns both tables plus the worker inventory, and produces the
``conf`` view consumed by :func:`repro.core.scheduler.schedule` (Listing 1).
It is thread-safe, supports elastic add/remove/fail of workers, and offers an
optimistic-concurrency hook (``expected_version``) for the multi-controller
races the paper flags as future work (§VII).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

from .ast import AAppError

# Change-feed listener: ``fn(kind, payload)`` with kind in
# {"allocate", "complete", "add_worker", "fail_worker", "zone_change"}.
# Payload fields:
#   allocate    {"activation": Activation}
#   complete    {"activation": Activation}
#   add_worker  {"worker": str, "max_memory": float, "reused": bool,
#                "zone": str}
#   fail_worker {"worker": str, "lost": List[Activation]}
#   zone_change {"workers": Tuple[str, ...]}
# Listeners fire synchronously inside the state lock, in mutation order —
# the incremental scheduling data plane (`repro.core.batched.SchedulerSession`)
# relies on seeing every delta exactly once and in order.
#
# The feed is additionally *partitioned by zone*: ``add_zone_listener``
# subscribes to only the mutations touching one zone's workers, and
# ``zone_version(zone)`` counts them — per-zone scheduler shards
# (:class:`repro.core.sharded.ShardedSession`) rebuild only when *their*
# zone churns, which is what keeps per-shard tensors small and quiet as the
# cluster grows.
StateListener = Callable[[str, Dict], None]


class ConcurrencyConflict(Exception):
    """Optimistic allocation raced with another controller's update."""


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    """Registry entry: ``reg[f] = (memory, tag)`` in Listing 1."""

    memory: float
    tag: str


class Registry:
    """Function name -> (memory, tag)."""

    def __init__(self, entries: Optional[Mapping[str, Tuple[float, str]]] = None):
        self._entries: Dict[str, FunctionSpec] = {}
        if entries:
            for name, (memory, tag) in entries.items():
                self.register(name, memory=memory, tag=tag)

    def register(self, name: str, *, memory: float, tag: str) -> None:
        if memory < 0:
            raise AAppError(f"function {name!r}: negative memory")
        self._entries[name] = FunctionSpec(memory=float(memory), tag=tag)

    def __getitem__(self, name: str) -> FunctionSpec:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"function {name!r} not registered") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> Tuple[str, ...]:
        return tuple(self._entries)

    def tags(self) -> Tuple[str, ...]:
        return tuple(sorted({s.tag for s in self._entries.values()}))


@dataclasses.dataclass(frozen=True)
class Activation:
    """A running function instance."""

    activation_id: str
    function: str
    tag: str
    memory: float
    worker: str


@dataclasses.dataclass(frozen=True)
class WorkerView:
    """The per-worker slice of ``conf`` that Listing 1 reads."""

    fs: Tuple[str, ...]  # function names of resident instances
    tags: Tuple[str, ...]  # their tags (parallel to fs)
    memory_used: float
    max_memory: float
    zone: str = ""  # topology membership ("" when no zones are configured)

    def tag_set(self) -> frozenset:
        return frozenset(self.tags)


Conf = Dict[str, WorkerView]


class ClusterState:
    """Worker inventory + the two tracking tables."""

    def __init__(self):
        self._lock = threading.RLock()
        self._max_memory: Dict[str, float] = {}
        self._alive: Dict[str, bool] = {}
        # activeFunctions: worker -> {activation_id: Activation}
        self._active_functions: Dict[str, Dict[str, Activation]] = {}
        # activeTagActivations: activation_id -> Activation
        self._active_tag_activations: Dict[str, Activation] = {}
        self._ids = itertools.count()
        self._version = 0
        self._listeners: List[StateListener] = []
        # topology: worker -> zone ("" = unzoned); per-zone feed partition
        self._zones: Dict[str, str] = {}
        self._zone_order: Dict[str, None] = {}  # first-seen zone order
        self._zone_alive: Dict[str, int] = {}  # alive workers per zone
        self._zone_versions: Dict[str, int] = {}
        self._zone_listeners: Dict[str, List[StateListener]] = {}
        self._zone_nacts: Dict[str, int] = {}  # resident instances per zone

    # -- change feed --------------------------------------------------------- #

    def add_listener(self, fn: StateListener) -> None:
        """Subscribe to the mutation feed (see :data:`StateListener`)."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: StateListener) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def add_zone_listener(self, zone: str, fn: StateListener) -> None:
        """Subscribe to the zone's partition of the feed: only mutations
        whose worker lives in ``zone`` are delivered."""
        with self._lock:
            self._zone_listeners.setdefault(zone, []).append(fn)

    def remove_zone_listener(self, zone: str, fn: StateListener) -> None:
        with self._lock:
            fns = self._zone_listeners.get(zone, [])
            if fn in fns:
                fns.remove(fn)

    def _emit(self, kind: str, payload: Dict, *, zone: Optional[str] = None) -> None:
        for fn in self._listeners:
            fn(kind, payload)
        if zone is None:
            return
        self._zone_versions[zone] = self._zone_versions.get(zone, 0) + 1
        for fn in self._zone_listeners.get(zone, []):
            fn(kind, payload)

    # -- topology ------------------------------------------------------------ #

    def zone_of(self, worker: str) -> str:
        with self._lock:
            return self._zones.get(worker, "")

    def zones(self) -> Tuple[str, ...]:
        """Distinct zones with at least one alive worker, first-seen order
        (the platform's stable zone order).  O(#zones-ever-seen) — the
        sharded router reads it on every decision."""
        with self._lock:
            alive = self._zone_alive
            return tuple(z for z in self._zone_order if alive.get(z, 0) > 0)

    def zone_version(self, zone: str) -> int:
        """Mutation count of the zone's feed partition (0 if never touched)."""
        with self._lock:
            return self._zone_versions.get(zone, 0)

    def zone_load(self, zone: str) -> int:
        """Resident function instances across the zone's workers (O(1) —
        maintained on allocate/complete/fail)."""
        with self._lock:
            return self._zone_nacts.get(zone, 0)

    def set_zones(self, mapping: Mapping[str, object]) -> None:
        """(Re)assign worker zones from an explicit map.  Values may be zone
        name strings or spec objects carrying a ``.zone`` attribute
        (:class:`~repro.cluster.topology.WorkerSpec` / ``CellSpec``).  Bumps
        the version and emits ``zone_change`` so live sessions rebuild."""
        with self._lock:
            touched: List[str] = []
            affected: Dict[str, None] = {}
            for worker, z in mapping.items():
                zone = str(getattr(z, "zone", z))
                old = self._zones.get(worker, "")
                if old == zone:
                    continue
                affected.setdefault(old)
                affected.setdefault(zone)
                alive = self._alive.get(worker, False)
                n = len(self._active_functions.get(worker, {})) if alive else 0
                if n:
                    self._zone_nacts[old] = self._zone_nacts.get(old, 0) - n
                    self._zone_nacts[zone] = self._zone_nacts.get(zone, 0) + n
                if alive:
                    self._zone_alive[old] = self._zone_alive.get(old, 0) - 1
                    self._zone_alive[zone] = self._zone_alive.get(zone, 0) + 1
                self._zones[worker] = zone
                if worker in self._max_memory:
                    self._zone_order.setdefault(zone)
                touched.append(worker)
            if not touched:
                return
            self._version += 1
            payload = {"workers": tuple(touched)}
            for fn in self._listeners:
                fn("zone_change", payload)
            for zone in affected:
                self._zone_versions[zone] = self._zone_versions.get(zone, 0) + 1
                for fn in self._zone_listeners.get(zone, []):
                    fn("zone_change", payload)

    # -- worker inventory (elastic) ---------------------------------------- #

    def add_worker(self, worker: str, *, max_memory: float,
                   zone: Optional[str] = None) -> None:
        with self._lock:
            if worker in self._max_memory and self._alive[worker]:
                raise AAppError(f"worker {worker!r} already present")
            reused = worker in self._max_memory  # re-join keeps its conf slot
            self._max_memory[worker] = float(max_memory)
            self._alive[worker] = True
            self._active_functions.setdefault(worker, {})
            if zone is not None:
                self._zones[worker] = str(zone)
            wzone = self._zones.get(worker, "")
            self._zone_order.setdefault(wzone)
            self._zone_alive[wzone] = self._zone_alive.get(wzone, 0) + 1
            self._version += 1
            self._emit("add_worker", {"worker": worker,
                                      "max_memory": float(max_memory),
                                      "reused": reused,
                                      "zone": wzone},
                       zone=wzone)

    def remove_worker(self, worker: str) -> List[Activation]:
        """Gracefully drain: returns the activations that must be rescheduled."""
        return self.fail_worker(worker)

    def fail_worker(self, worker: str) -> List[Activation]:
        """A worker disappeared (crash / pre-emption).  Its activations are
        evicted from both tables and returned for rescheduling."""
        with self._lock:
            if worker not in self._max_memory:
                return []
            was_alive = self._alive.get(worker, False)
            self._alive[worker] = False
            if was_alive:
                z = self._zones.get(worker, "")
                self._zone_alive[z] = self._zone_alive.get(z, 0) - 1
            lost = list(self._active_functions.get(worker, {}).values())
            self._active_functions[worker] = {}
            for act in lost:
                self._active_tag_activations.pop(act.activation_id, None)
            wzone = self._zones.get(worker, "")
            if lost:
                self._zone_nacts[wzone] = \
                    self._zone_nacts.get(wzone, 0) - len(lost)
            self._version += 1
            self._emit("fail_worker", {"worker": worker, "lost": lost},
                       zone=wzone)
            return lost

    def workers(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(w for w, alive in self._alive.items() if alive)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    # -- conf view ---------------------------------------------------------- #

    def conf(self) -> Conf:
        with self._lock:
            out: Conf = {}
            for w, alive in self._alive.items():
                if not alive:
                    continue
                acts = self._active_functions.get(w, {})
                out[w] = WorkerView(
                    fs=tuple(a.function for a in acts.values()),
                    tags=tuple(a.tag for a in acts.values()),
                    memory_used=sum(a.memory for a in acts.values()),
                    max_memory=self._max_memory[w],
                    zone=self._zones.get(w, ""),
                )
            return out

    def conf_zone(self, zone: str) -> Conf:
        """``conf()`` restricted to one zone's alive workers (same per-worker
        views, same insertion order) — the shard view's working set."""
        with self._lock:
            out: Conf = {}
            for w, alive in self._alive.items():
                if not alive or self._zones.get(w, "") != zone:
                    continue
                acts = self._active_functions.get(w, {})
                out[w] = WorkerView(
                    fs=tuple(a.function for a in acts.values()),
                    tags=tuple(a.tag for a in acts.values()),
                    memory_used=sum(a.memory for a in acts.values()),
                    max_memory=self._max_memory[w],
                    zone=zone,
                )
            return out

    def tag_counts(self, worker: str) -> Dict[str, int]:
        with self._lock:
            counts: Dict[str, int] = {}
            for a in self._active_functions.get(worker, {}).values():
                counts[a.tag] = counts.get(a.tag, 0) + 1
            return counts

    # -- the two tables ------------------------------------------------------ #

    def allocate(
        self,
        function: str,
        worker: str,
        reg: Registry,
        *,
        expected_version: Optional[int] = None,
    ) -> Activation:
        """Record an allocation decision.  With ``expected_version`` this is a
        compare-and-swap: it fails if another controller changed the state since
        the caller computed its decision (multi-controller safety)."""
        with self._lock:
            if expected_version is not None and expected_version != self._version:
                raise ConcurrencyConflict(
                    f"state moved from v{expected_version} to v{self._version}"
                )
            if not self._alive.get(worker, False):
                raise AAppError(f"worker {worker!r} not available")
            spec = reg[function]
            act = Activation(
                activation_id=f"act-{next(self._ids)}",
                function=function,
                tag=spec.tag,
                memory=spec.memory,
                worker=worker,
            )
            self._active_functions[worker][act.activation_id] = act
            self._active_tag_activations[act.activation_id] = act
            wzone = self._zones.get(worker, "")
            self._zone_nacts[wzone] = self._zone_nacts.get(wzone, 0) + 1
            self._version += 1
            self._emit("allocate", {"activation": act}, zone=wzone)
            return act

    def complete(self, activation_id: str) -> Optional[Activation]:
        """Completion notification from a worker: look the activation up in
        ``activeTagActivations`` and drop that instance from
        ``activeFunctions`` (paper §IV)."""
        with self._lock:
            act = self._active_tag_activations.pop(activation_id, None)
            if act is None:
                return None  # worker already failed / duplicate ack
            self._active_functions.get(act.worker, {}).pop(activation_id, None)
            wzone = self._zones.get(act.worker, "")
            self._zone_nacts[wzone] = self._zone_nacts.get(wzone, 0) - 1
            self._version += 1
            self._emit("complete", {"activation": act}, zone=wzone)
            return act

    def active_activations(self) -> Tuple[Activation, ...]:
        with self._lock:
            return tuple(self._active_tag_activations.values())

    # -- bulk load (tests / simulator) ---------------------------------------- #

    @staticmethod
    def from_conf(conf: Conf) -> Tuple["ClusterState", Registry]:
        """Rebuild a state + registry from a plain ``conf`` mapping (testing)."""
        state = ClusterState()
        reg = Registry()
        n = 0
        for w, view in conf.items():
            state.add_worker(w, max_memory=view.max_memory,
                             zone=view.zone or None)
            per = view.memory_used / len(view.fs) if view.fs else 0.0
            for fname, tag in zip(view.fs, view.tags):
                if fname not in reg:
                    reg.register(fname, memory=per, tag=tag)
                state.allocate(fname, w, reg)
                n += 1
        return state, reg
