"""Plain reference of the placements: which cells the engine's synthesised
Listing-1 policy admits for each request, worked out again from the
deployment the benchmark set up and the requests it sent.

The cluster: ``pods`` x ``cells_per_pod`` cells named ``<pod>-cell<i>``,
each holding ``chips_per_cell x hbm_per_chip_gb`` GB, in that order.  The
model's weights sit on ``model_cells`` (``weights_gb`` each, tag
``model:<M>``); a train tenant, when there is one, holds ``req_gb`` with
tag ``train`` for the whole run; each session's KV holds
``kv_gb_per_session`` with tag ``kv:<session>`` on the cell of its last
prefill.

A prefill's policy has two blocks over every cell, both invalid on a cell
at 95% of its memory or more: first ``model:<M>`` and not ``train``, then
``model:<M>`` alone.  The train tenant's is one block, not
``decode:<M>``, followed by the default block (every cell).  A cell is
valid when the request's ``req_gb`` fits and the block's tags hold; the
first block with a valid cell is the one the request may land in.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

#: (affine tags, anti-affine tags, capacity limit in % or None) per block
Blocks = List[Tuple[Tuple[str, ...], Tuple[str, ...], Optional[float]]]


class Cluster:
    def __init__(self, dep: dict, model: str):
        self.dep, self.model = dep, model
        self.cells = [f"{p}-cell{i}" for p in dep["pods"]
                      for i in range(dep["cells_per_pod"])]
        self.max = {c: dep["chips_per_cell"] * dep["hbm_per_chip_gb"]
                    for c in self.cells}
        self.used: Dict[str, float] = {c: 0.0 for c in self.cells}
        self.tags: Dict[str, Counter] = {c: Counter() for c in self.cells}
        self.kv: Dict[str, str] = {}
        for c in dep["model_cells"]:
            self.hold(c, dep["weights_gb"], f"model:{model}")

    def hold(self, cell: str, gb: float, tag: str) -> None:
        self.used[cell] += gb
        self.tags[cell][tag] += 1

    def release(self, cell: str, gb: float, tag: str) -> None:
        self.used[cell] -= gb
        self.tags[cell][tag] -= 1

    def valid(self, cell: str, need: float, affine, anti, cap) -> bool:
        if self.used[cell] + need > self.max[cell]:
            return False
        if cap is not None and self.used[cell] >= cap / 100.0 * self.max[cell]:
            return False
        held = {t for t, n in self.tags[cell].items() if n > 0}
        return all(t in held for t in affine) and not any(t in held
                                                          for t in anti)

    def admitted(self, blocks: Blocks) -> List[str]:
        need = self.dep["req_gb"]
        for affine, anti, cap in blocks:
            ok = [c for c in self.cells if self.valid(c, need, affine, anti,
                                                      cap)]
            if ok:
                return ok
        return []

    def prefill_blocks(self) -> Blocks:
        m = f"model:{self.model}"
        return [((m,), ("train",), 95.0), ((m,), (), 95.0)]

    def train_blocks(self) -> Blocks:
        return [((), (f"decode:{self.model}",), None), ((), (), None)]


def misplaced(dep: dict, model: str, placements) -> List[int]:
    """``placements``: the requests the engine was sent, in order, as
    ``(kind, session, cell)`` with kind ``train`` or ``prefill``.  Returns
    the positions of those whose cell the policy does not admit."""
    cl = Cluster(dep, model)
    bad = []
    for n, (kind, session, cell) in enumerate(placements):
        if kind == "train":
            if cell not in cl.admitted(cl.train_blocks()):
                bad.append(n)
            if cell in cl.used:
                cl.hold(cell, dep["req_gb"], "train")
            continue
        if cell not in cl.admitted(cl.prefill_blocks()):
            bad.append(n)
        if cell not in cl.used:
            continue
        old = cl.kv.pop(session, None)
        if old is not None:
            cl.release(old, dep["kv_gb_per_session"], f"kv:{session}")
        cl.hold(cell, dep["kv_gb_per_session"], f"kv:{session}")
        cl.kv[session] = cell
    return bad
