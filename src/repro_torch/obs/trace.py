"""Decision tracing — a ring-buffered structured span recorder.

The :class:`Tracer` captures each decision's lifecycle *as it happens*:
arrival/begin → compile/reload → zone route (admissible zones, hint, shard
hops) → block-chain walk (per-block verdicts reusing the
``rejection_reason`` vocabulary, so live traces agree with ``explain()``) →
pool acquire (cold/warm/hot + charged latency) → completion.

Hot-path discipline: records are compact tuples appended to a bounded
``deque`` — no dicts, no string formatting, no clock reads beyond the
platform clock the caller already holds.  Ids are deterministic: invocation
spans are keyed by their activation id; pre-allocation records by a
``d<seq>`` counter.  No wall-clock and no randomness enter a record, so a
simulator run traces bit-identically across replays.

Two exports: :meth:`Tracer.to_jsonl` (one JSON object per record) and
:meth:`Tracer.chrome_trace` — Chrome-trace/Perfetto timeline JSON keyed by
the recording clock (the simulator's virtual time), one process per zone,
one thread per worker plus a per-zone ``scheduler`` control track.
:func:`validate_chrome_trace` checks the schema (sorted ts, matched B/E,
non-negative X durations) and is what the CI smoke asserts.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

#: per-record field names, keyed by the tuple's leading kind marker —
#: the jsonl export zips these against the raw tuples.
RECORD_FIELDS: Dict[str, Tuple[str, ...]] = {
    "begin": ("kind", "id", "t", "function", "zone"),
    "decision": ("kind", "id", "t", "function", "worker", "zone"),
    "invoke": ("kind", "id", "t", "function", "worker", "start_kind",
               "start_cost", "zone", "decision_id"),
    "complete": ("kind", "id", "t"),
    "blocks": ("kind", "id", "t", "function", "block_index", "worker",
               "verdicts"),
    "route": ("kind", "id", "t", "function", "tag", "hint", "admissible",
              "tried", "hops", "zone"),
    "compile": ("kind", "id", "t", "event", "tags"),
}

_SCHED_TID = 0  # per-zone control track for decision/route instants


class Tracer:
    """Bounded ring of structured decision records.

    ``capacity`` bounds memory (oldest records drop first; every eviction
    bumps ``dropped_spans``, which the obs snapshot surfaces so a wrapped
    ring is visible instead of silently truncating exports);
    ``verdicts=True`` additionally makes the scheduling session record a
    per-block, per-worker verdict list for every decision — the explain-
    agreement surface, deliberately *not* on the perf budget (the
    ``overhead.py --obs`` gate runs with ``verdicts=False``)."""

    def __init__(self, capacity: int = 65536, verdicts: bool = False):
        self.events: "deque[tuple]" = deque(maxlen=capacity)
        self.verdicts = verdicts
        self.dropped_spans = 0  # records evicted by the ring bound
        self._cap = capacity
        self._seq = 0
        self._cur = 0    # current decision seq (set by begin)
        self._cur_t = 0.0  # current decision scope's begin time

    def __len__(self) -> int:
        return len(self.events)

    # ---- recording (hot path: tuple appends only) -------------------------- #
    # decision ids are stored as raw ints and rendered "d<seq>" at export —
    # no string formatting on the hot path

    def begin(self, t: float, function: str,
              zone: Optional[str] = None) -> int:
        """Open a decision scope: subsequent route/blocks/decision records
        share the returned deterministic seq (rendered ``d<seq>`` in
        exports)."""
        self._seq += 1
        did = self._seq
        self._cur = did
        self._cur_t = t
        if len(self.events) == self._cap:
            self.dropped_spans += 1
        self.events.append(("begin", did, t, function, zone))
        return did

    def decision(self, t: float, function: str, worker: Optional[str],
                 zone: Optional[str] = None) -> None:
        if len(self.events) == self._cap:
            self.dropped_spans += 1
        self.events.append(("decision", self._cur, t, function, worker, zone))

    def invoke(self, aid: str, t: float, function: str, worker: str,
               start_kind: Optional[str], start_cost: float,
               zone: Optional[str] = None) -> None:
        if len(self.events) == self._cap:
            self.dropped_spans += 1
        self.events.append(("invoke", aid, t, function, worker, start_kind,
                            start_cost, zone, self._cur))

    def complete(self, aid: str, t: float) -> None:
        if len(self.events) == self._cap:
            self.dropped_spans += 1
        self.events.append(("complete", aid, t))

    def blocks(self, function: str, block_index: Optional[int],
               worker: Optional[str], verdicts=None) -> None:
        """One block-chain walk: the winning block index and worker (``None``
        for unschedulable), plus — in verdict mode — a tuple of
        ``(block_index, ((worker, ok, reason), ...))`` per evaluated block.
        Stamped with the enclosing decision scope's begin time — the walk is
        instantaneous on the recording clock, and skipping a fresh clock
        read keeps this call off the scheduler's critical-path budget."""
        if len(self.events) == self._cap:
            self.dropped_spans += 1
        self.events.append(("blocks", self._cur, self._cur_t, function,
                            block_index, worker, verdicts))

    def route(self, t: float, function: str, tag: str, hint: str,
              admissible, tried, hops: int,
              zone: Optional[str]) -> None:
        """One zone-router pass: per evaluated block the admitted zones,
        the zone-selection hint, the exhausted ``(block, zone)`` hops tried,
        and the winning zone (``None`` when the chain ran dry)."""
        if len(self.events) == self._cap:
            self.dropped_spans += 1
        self.events.append(("route", self._cur, t, function, tag, hint,
                            admissible, tried, hops, zone))

    def compile_event(self, t: float, event: str, tags: int) -> None:
        if len(self.events) == self._cap:
            self.dropped_spans += 1
        self.events.append(("compile", self._cur, t, event, tags))

    # ---- exports ----------------------------------------------------------- #

    def records(self) -> List[Dict]:
        """Records as dicts (field names from :data:`RECORD_FIELDS`);
        integer decision seqs render as ``d<seq>``."""
        out: List[Dict] = []
        for ev in self.events:
            r = dict(zip(RECORD_FIELDS[ev[0]], ev))
            if isinstance(r["id"], int):
                r["id"] = f"d{r['id']}"
            did = r.get("decision_id")
            if isinstance(did, int):
                r["decision_id"] = f"d{did}"
            out.append(r)
        return out

    def to_jsonl(self) -> str:
        return "\n".join(
            json.dumps(r, default=str) for r in self.records()) + "\n"

    def chrome_trace(self) -> Dict:
        """Chrome-trace (``chrome://tracing`` / Perfetto) timeline JSON.

        Mapping: one *process* per zone (unzoned workers under ``cluster``),
        one *thread* per worker, plus thread 0 per process for scheduler
        control records.  Invoke/complete pairs (matched by activation id)
        become ``X`` complete events (``ts``/``dur`` in microseconds of the
        recording clock); unmatched invokes and decision/route/compile
        records become ``i`` instants.  Events are sorted by ``ts`` with the
        ``M`` metadata block first — the layout
        :func:`validate_chrome_trace` pins."""
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[int, str], int] = {}

        def pid_of(zone: Optional[str]) -> int:
            z = zone if zone else "cluster"
            got = pids.get(z)
            if got is None:
                got = pids[z] = len(pids) + 1
            return got

        def tid_of(pid: int, worker: str) -> int:
            got = tids.get((pid, worker))
            if got is None:
                # tid 0 is the scheduler control track
                got = tids[(pid, worker)] = 1 + sum(
                    1 for (p, _w) in tids if p == pid)
            return got

        completes: Dict[str, float] = {}
        for ev in self.events:
            if ev[0] == "complete":
                completes[ev[1]] = ev[2]

        zone_of_worker: Dict[str, Optional[str]] = {}
        for ev in self.events:
            if ev[0] == "invoke" and ev[4] is not None:
                zone_of_worker.setdefault(ev[4], ev[7])

        events: List[Dict] = []
        for ev in self.events:
            kind = ev[0]
            if kind == "invoke":
                _, aid, t, fn, worker, skind, scost, zone, did = ev
                wzone = zone_of_worker.get(worker, zone)
                pid = pid_of(wzone)
                tid = tid_of(pid, worker)
                args = {"id": aid, "start_kind": skind,
                        "start_cost": scost, "decision_id": f"d{did}"}
                if zone is not None:
                    args["origin_zone"] = zone
                end = completes.get(aid)
                if end is not None:
                    events.append({"name": fn, "cat": "invoke", "ph": "X",
                                   "ts": t * 1e6,
                                   "dur": max(end - t, 0.0) * 1e6,
                                   "pid": pid, "tid": tid, "args": args})
                else:
                    events.append({"name": fn, "cat": "invoke", "ph": "i",
                                   "ts": t * 1e6, "s": "t",
                                   "pid": pid, "tid": tid, "args": args})
            elif kind == "decision":
                _, did, t, fn, worker, zone = ev
                pid = pid_of(zone)
                events.append({"name": f"decide {fn}", "cat": "decision",
                               "ph": "i", "ts": t * 1e6, "s": "t",
                               "pid": pid, "tid": _SCHED_TID,
                               "args": {"id": f"d{did}", "worker": worker}})
            elif kind == "route":
                _, did, t, fn, tag, hint, adm, tried, hops, zone = ev
                pid = pid_of(zone)
                events.append({"name": f"route {fn}", "cat": "route",
                               "ph": "i", "ts": t * 1e6, "s": "t",
                               "pid": pid, "tid": _SCHED_TID,
                               "args": {"id": f"d{did}", "tag": tag,
                                        "hint": hint, "hops": hops,
                                        "zone": zone}})
            elif kind == "compile":
                _, did, t, event, tags = ev
                events.append({"name": event, "cat": "compile", "ph": "i",
                               "ts": t * 1e6, "s": "p",
                               "pid": pid_of(None), "tid": _SCHED_TID,
                               "args": {"tags": tags}})
            # begin/blocks/complete records don't render standalone

        events.sort(key=lambda e: e["ts"])
        meta: List[Dict] = []
        for z, pid in sorted(pids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": f"zone:{z}"}})
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": _SCHED_TID, "args": {"name": "scheduler"}})
        for (pid, worker), tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": worker}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


_PHASES = frozenset("XBEiIM")


def validate_chrome_trace(obj) -> List[str]:
    """Schema check for :meth:`Tracer.chrome_trace` output (and any JSON
    headed for ``chrome://tracing``).  Returns a list of violations (empty
    means valid): known phase markers, numeric non-decreasing ``ts`` across
    non-metadata events, non-negative ``X`` durations, matched ``B``/``E``
    begin/end pairs per (pid, tid) track."""
    errs: List[str] = []
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        return ["top level must be a dict with a 'traceEvents' list"]
    last_ts = None
    stacks: Dict[Tuple, List[str]] = {}
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errs.append(f"event {i}: unknown phase {ph!r}")
            continue
        if "name" not in ev:
            errs.append(f"event {i}: missing name")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errs.append(f"event {i}: non-numeric ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            errs.append(f"event {i}: ts {ts} < previous {last_ts} (unsorted)")
        last_ts = ts
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i}: X event with bad dur {dur!r}")
        elif ph == "B":
            stacks.setdefault(key, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                errs.append(f"event {i}: E without matching B on {key}")
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            errs.append(f"track {key}: {len(stack)} unclosed B event(s)")
    return errs
