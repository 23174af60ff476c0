"""The paper's §II / §V *divide-et-impera* workload on :class:`ClusterSim`.

Users invoke `divide`; a running `divide` invokes two `impera` instances
(scheduling happens exactly at invocation time, as in OpenWhisk), waits for
them, then fetches their 100 result documents from the *local* storage replica
with 1 s exponential back-off (§V).  `heavy` variants are long compute jobs
pinned by the policy scripts to the small workers.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional

from repro_torch.core.state import Registry
from .simulator import ClusterSim

DIVIDE_MEM = 256.0
IMPERA_MEM = 192.0
HEAVY_MEM = 512.0


@dataclasses.dataclass
class DivideResult:
    latency: float
    retries: int
    failed: bool
    worker: str
    impera_workers: List[str]
    zone: str


class DivideImperaWorkload:
    def __init__(self, sim: ClusterSim, scheduler_fn: Callable[[str], Optional[str]]):
        self.sim = sim
        self.schedule = scheduler_fn
        self._idx = itertools.count()
        reg = sim.registry
        reg.register("divide", memory=DIVIDE_MEM, tag="d")
        reg.register("impera", memory=IMPERA_MEM, tag="i")
        reg.register("heavy_eu", memory=HEAVY_MEM, tag="h_eu")
        reg.register("heavy_us", memory=HEAVY_MEM, tag="h_us")
        self.results: List[DivideResult] = []

    # ---- heavy ------------------------------------------------------------- #

    def submit_heavy(self, variant: str, on_done: Callable[[], None]) -> None:
        sim = self.sim
        w = self.schedule(variant)
        if w is None:
            sim.failures.append(variant)
            on_done()
            return
        act = sim.state.allocate(variant, w, sim.registry)
        start = sim.container_start(variant, w, act.activation_id)

        def finish():
            sim.container_release(act.activation_id)
            sim.state.complete(act.activation_id)
            on_done()

        sim.after(sim.overhead(w) + start, lambda: sim.compute(
            variant, w, sim.p.heavy_compute, act.activation_id, finish))

    # ---- impera ------------------------------------------------------------- #

    def _submit_impera(self, index: str, on_done: Callable[[str], None]) -> None:
        sim = self.sim
        w = self.schedule("impera")
        if w is None:
            sim.failures.append("impera")
            on_done("<unschedulable>")
            return
        act = sim.state.allocate("impera", w, sim.registry)
        start = sim.container_start("impera", w, act.activation_id)

        def after_compute():
            conn = sim.db_connect(w)

            def write_and_finish():
                sim.db_write(index, w, sim.p.docs_per_impera)
                sim.container_release(act.activation_id)
                sim.state.complete(act.activation_id)
                # completion ack travels through the control plane
                sim.after(sim.p.notify_delay, lambda: on_done(w))

            sim.after(conn, write_and_finish)

        sim.after(sim.overhead(w) + start, lambda: sim.compute(
            "impera", w, sim.p.impera_compute, act.activation_id, after_compute))

    # ---- divide ------------------------------------------------------------- #

    def submit_divide(self, on_done: Callable[[DivideResult], None]) -> None:
        sim = self.sim
        t0 = sim.now
        index = f"idx-{next(self._idx)}"
        w = self.schedule("divide")
        if w is None:
            sim.failures.append("divide")
            res = DivideResult(float("nan"), 0, True, "<unschedulable>", [], "")
            self.results.append(res)
            on_done(res)
            return
        act = sim.state.allocate("divide", w, sim.registry)
        start = sim.container_start("divide", w, act.activation_id)
        impera_workers: List[str] = []
        retries = [0]

        def finish(failed: bool):
            sim.container_release(act.activation_id)
            sim.state.complete(act.activation_id)
            res = DivideResult(
                latency=sim.now - t0, retries=retries[0], failed=failed, worker=w,
                impera_workers=list(impera_workers), zone=sim.workers[w].zone,
            )
            self.results.append(res)
            on_done(res)

        def fetch(attempt: int):
            if sim.db_visible(index, w, 2 * sim.p.docs_per_impera):
                finish(False)
                return
            if attempt >= sim.p.max_retries:
                finish(True)
                return
            retries[0] += 1
            sim.after(sim.p.backoff_base * (2 ** attempt), lambda: fetch(attempt + 1))

        def after_imperas():
            sim.after(sim.db_connect(w), lambda: fetch(0))

        def after_compute():
            remaining = [2]

            def impera_done(iw: str):
                impera_workers.append(iw)
                remaining[0] -= 1
                if remaining[0] == 0:
                    after_imperas()

            # the *running* divide invokes the imperas: scheduled now (§II)
            for _ in range(2):
                self._submit_impera(index, impera_done)

        sim.after(sim.overhead(w) + start, lambda: sim.compute(
            "divide", w, sim.p.divide_compute, act.activation_id, after_compute))
