"""Cluster topology for the §V case study, the serving engine, and the
N-zone simulator.

The zone protocol
=================

Every worker-like spec — :class:`WorkerSpec` (OpenWhisk invokers, Fig. 7)
and :class:`CellSpec` (TPU sub-meshes, DESIGN.md) — carries a real ``zone``
field.  :func:`zone_map` projects any spec mapping down to the
``{worker: zone}`` dict the rest of the stack consumes
(:meth:`repro_torch.core.state.ClusterState.set_zones`,
``Platform(..., zones=...)``, the simulator's DB replica placement), so
zones are plumbed once instead of per-consumer (``CellSpec`` used to spell
its zone ``pod`` and alias it — the alias is gone).

:class:`ZoneTopology` generalises the paper's hard-coded eu/us pair: an
N-zone control-plane-overhead vector plus a replication-lag factor matrix,
with :meth:`ZoneTopology.default` reproducing the seed behaviour exactly
(control plane in the first zone, every other zone pays one flat overhead,
unit lag factors).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    name: str
    zone: str
    vcpus: float
    memory_mb: float


def paper_testbed() -> Dict[str, WorkerSpec]:
    """Fig. 7: 6 OpenWhisk workers — per zone, 2 x (2 vCPU / 2 GB) and
    1 x (1 vCPU / 1 GB); heavies are pinned to the small ones."""
    return {
        "workereu1": WorkerSpec("workereu1", "eu", 1, 1024),
        "workereu2": WorkerSpec("workereu2", "eu", 2, 2048),
        "workereu3": WorkerSpec("workereu3", "eu", 2, 2048),
        "workerus1": WorkerSpec("workerus1", "us", 1, 1024),
        "workerus2": WorkerSpec("workerus2", "us", 2, 2048),
        "workerus3": WorkerSpec("workerus3", "us", 2, 2048),
    }


def multizone_testbed(zones: Tuple[str, ...] = ("eu", "us", "ap"),
                      replicas: int = 1) -> Dict[str, WorkerSpec]:
    """The paper's per-zone worker shape (1 small + 2 big) generalised to an
    arbitrary zone list, optionally replicated ``replicas`` times per zone."""
    out: Dict[str, WorkerSpec] = {}
    for z in zones:
        for r in range(replicas):
            sfx = f"r{r}" if replicas > 1 else ""
            for i, (vcpus, mem) in enumerate(((1, 1024), (2, 2048), (2, 2048))):
                name = f"worker{z}{i + 1}{sfx}"
                out[name] = WorkerSpec(name, z, vcpus, mem)
    return out


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """A TPU sub-mesh 'worker' for the serving engine (DESIGN.md mapping).
    ``zone`` is the pod it lives in — the same field name as
    :class:`WorkerSpec`, so both satisfy the zone protocol directly."""

    name: str
    zone: str
    chips: int
    hbm_gb: float


def zone_map(specs: Mapping[str, object]) -> Dict[str, str]:
    """Project any ``{worker: spec}`` mapping (or an existing
    ``{worker: zone-name}`` dict) to ``{worker: zone}``."""
    return {name: str(getattr(spec, "zone", spec))
            for name, spec in specs.items()}


def two_pod_cells(cells_per_pod: int = 4, chips_per_cell: int = 64,
                  hbm_per_chip_gb: float = 16.0) -> Dict[str, CellSpec]:
    out = {}
    for pod in ("pod0", "pod1"):
        for i in range(cells_per_pod):
            name = f"{pod}-cell{i}"
            out[name] = CellSpec(name, pod, chips_per_cell,
                                 chips_per_cell * hbm_per_chip_gb)
    return out


@dataclasses.dataclass(frozen=True)
class ZoneTopology:
    """N-zone latency/replication model for the simulator.

    ``zones``        — stable zone order (first zone hosts the control plane
                       unless ``control_zone`` says otherwise);
    ``overhead``     — per-zone extra invocation overhead in seconds (the
                       paper's EU/US control-plane asymmetry, generalised);
                       the control zone always reads 0.0;
    ``lag_factor``   — ``(src, dst)`` multipliers on the sampled replication
                       lag: a write in ``src`` becomes visible in ``dst``
                       after ``lag * factor``.  Missing pairs default 1.0
                       (the seed's symmetric 2-zone behaviour).
    """

    zones: Tuple[str, ...]
    control_zone: str = ""
    overhead: Mapping[str, float] = dataclasses.field(default_factory=dict)
    lag_factor: Mapping[Tuple[str, str], float] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if not self.zones:
            raise ValueError("ZoneTopology needs at least one zone")
        if not self.control_zone:
            object.__setattr__(self, "control_zone", self.zones[0])
        if self.control_zone not in self.zones:
            raise ValueError(
                f"control zone {self.control_zone!r} not in {self.zones}")

    @staticmethod
    def default(zones: Tuple[str, ...], *,
                remote_overhead: float) -> "ZoneTopology":
        """The seed model on N zones: the control plane lives in the ``eu``
        zone when one exists (the paper's rule — historically hard-coded as
        'us pays the overhead' regardless of worker order), else in the
        first observed zone; every other zone pays a flat
        ``remote_overhead``; unit lag factors."""
        zones = tuple(zones)
        control = "eu" if "eu" in zones else zones[0]
        return ZoneTopology(
            zones=zones,
            control_zone=control,
            overhead={z: remote_overhead for z in zones if z != control},
        )

    def overhead_of(self, zone: str) -> float:
        if zone == self.control_zone:
            return 0.0
        return float(self.overhead.get(zone, 0.0))

    def factor(self, src: str, dst: str) -> float:
        return float(self.lag_factor.get((src, dst), 1.0))
