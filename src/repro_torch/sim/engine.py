"""Multi-stream discrete-event scheduler (the Timeloop-analogue evaluator).

A schedule is a list of Tasks bound to units ("MAC", "VEC", "DMA" — per
simulated core). Each unit executes one task at a time; among READY tasks
(all dependencies finished) the unit picks the earliest-emitted one — i.e.
the stream order encodes priority, but a blocked task does not head-of-line
block the queue (DMA engines reorder descriptors; the MAC/VEC streams are
dataflow-scheduled, as in TileFlow). Makespan, per-unit busy time, byte
counters and the §5.3 energy breakdown fall out of the trace.

``simulate`` never mutates its input tasks: resolved start/end times live
in local arrays, and ``return_timeline=True`` attaches COPIES of the
tasks with their times filled to ``SimResult.timeline`` — the payload
``repro_torch.obs.trace.tasks_to_chrome`` renders onto VEC/MXU/DMA
tracks for Perfetto (DESIGN.md §8). ``busy_by_tag`` /
``dram_bytes_by_tag`` break busy cycles and DRAM traffic down by tag
family ("C", "P", "O", "K"...) so consumers stop re-deriving it from raw
task lists.

The sim models ONE core carrying heads/cores of the workload with its
bandwidth share; SimResult scales the extensive quantities (bytes, ops,
energy) back to the whole device, while `cycles` is the device makespan.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

from repro_torch.obs.trace import tag_key
from repro_torch.sim.hw import HWConfig


@dataclasses.dataclass
class Task:
    unit: str
    cycles: float
    deps: tuple[int, ...] = ()
    tag: str = ""
    dram_read_bytes: int = 0   # DRAM->L1 traffic (DMA tasks)
    dram_write_bytes: int = 0  # L1->DRAM traffic
    l1_bytes: int = 0          # L1 reads+writes caused by this task
    mac_ops: float = 0.0
    vec_ops: float = 0.0
    # resolved by simulate() on TIMELINE COPIES only — input tasks are
    # never written (callers may reuse/share schedule lists freely)
    start: float = 0.0
    end: float = 0.0


@dataclasses.dataclass
class SimResult:
    cycles: float
    busy: dict[str, float]
    dram_read_bytes: int
    dram_write_bytes: int
    l1_bytes: int
    mac_ops: float
    vec_ops: float
    energy_pj: float
    energy_breakdown: dict[str, float]
    n_tasks: int
    # per-core busy cycles / device DRAM bytes grouped by tag family
    busy_by_tag: dict[str, float] = dataclasses.field(default_factory=dict)
    dram_bytes_by_tag: dict[str, int] = dataclasses.field(
        default_factory=dict)
    # resolved task copies with start/end set (return_timeline=True only)
    timeline: list[Task] | None = None

    @property
    def utilization(self) -> dict[str, float]:
        return {u: b / self.cycles for u, b in self.busy.items()}


def simulate(tasks: list[Task], hw: HWConfig, *,
             return_timeline: bool = False) -> SimResult:
    n = len(tasks)
    indeg = [len(t.deps) for t in tasks]
    dependents: dict[int, list[int]] = defaultdict(list)
    for i, t in enumerate(tasks):
        for d in t.deps:
            dependents[d].append(i)

    ready: dict[str, list[int]] = defaultdict(list)  # unit -> heap of idx
    idle: dict[str, bool] = defaultdict(lambda: True)
    units: set[str] = {t.unit for t in tasks}
    events: list[tuple[float, int]] = []  # (end_time, idx)
    start = [0.0] * n
    end = [0.0] * n

    for i, t in enumerate(tasks):
        if indeg[i] == 0:
            heapq.heappush(ready[t.unit], i)

    def try_start(unit: str, now: float):
        if idle[unit] and ready[unit]:
            i = heapq.heappop(ready[unit])
            start[i] = now
            end[i] = now + tasks[i].cycles
            idle[unit] = False
            heapq.heappush(events, (end[i], i))

    for u in units:
        try_start(u, 0.0)

    completed = 0
    while events:
        now, i = heapq.heappop(events)
        idle[tasks[i].unit] = True
        completed += 1
        for d in dependents[i]:
            indeg[d] -= 1
            if indeg[d] == 0:
                heapq.heappush(ready[tasks[d].unit], d)
        for u in units:
            try_start(u, now)
    assert completed == n, "dependency cycle in schedule"

    busy: dict[str, float] = defaultdict(float)
    busy_by_tag: dict[str, float] = defaultdict(float)
    dram_by_tag: dict[str, int] = defaultdict(int)
    dram_r = dram_w = l1 = 0
    mac_ops = vec_ops = 0.0
    for t in tasks:
        busy[t.unit] += t.cycles
        key = tag_key(t.tag) or t.unit
        busy_by_tag[key] += t.cycles
        dram_r += t.dram_read_bytes
        dram_w += t.dram_write_bytes
        if t.dram_read_bytes or t.dram_write_bytes:
            dram_by_tag[key] += t.dram_read_bytes + t.dram_write_bytes
        l1 += t.l1_bytes
        mac_ops += t.mac_ops
        vec_ops += t.vec_ops

    makespan = max(end, default=0.0)
    c = hw.cores  # scale per-core extensive quantities to the device
    dram_r, dram_w, l1 = dram_r * c, dram_w * c, l1 * c
    mac_ops, vec_ops = mac_ops * c, vec_ops * c
    e_dram = (dram_r + dram_w) * hw.dram_pj_per_byte
    e_l1 = l1 * hw.l1_pj_per_byte
    # Every operand flows L1 -> L0 -> PE; each MAC touches two operands
    # and a partial sum in the register file, each VEC op two operands.
    e_l0 = (3 * mac_ops + 2 * vec_ops) * hw.bytes_per_elem * hw.l0_pj_per_byte
    e_pe = mac_ops * hw.mac_pj_per_op + vec_ops * hw.vec_pj_per_op
    breakdown = {"dram": e_dram, "l1": e_l1, "l0": e_l0, "pe": e_pe}
    timeline = None
    if return_timeline:
        timeline = [dataclasses.replace(t, start=start[i], end=end[i])
                    for i, t in enumerate(tasks)]
    return SimResult(
        cycles=makespan,
        busy=dict(busy),
        dram_read_bytes=dram_r,
        dram_write_bytes=dram_w,
        l1_bytes=l1,
        mac_ops=mac_ops,
        vec_ops=vec_ops,
        energy_pj=sum(breakdown.values()),
        energy_breakdown=breakdown,
        n_tasks=len(tasks),
        busy_by_tag={k: busy_by_tag[k] for k in sorted(busy_by_tag)},
        dram_bytes_by_tag={k: dram_by_tag[k] * c
                           for k in sorted(dram_by_tag)},
        timeline=timeline,
    )
