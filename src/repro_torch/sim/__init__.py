"""Event-driven cycle/energy model of the paper's edge accelerator.

Reproduces the paper's evaluation substrate (Timeloop/Accelergy/TileFlow
stack, §5.1) analytically: a 2-core device, each core with a 16x16 MAC
mesh and a 256-lane VEC unit at 3.75 GHz, a shared 5 MB L1, and a
30 GB/s DRAM. Schedules for all six methods of §5 are built as explicit
tiled task graphs and run through a multi-stream list scheduler.

A copy of ``repro/sim`` with its imports taken from ``repro_torch``: the
same schedules, the same search and the same results, cycle for cycle.
The simulated device stays the paper's edge NPU (``EDGE_HW``); the
port's card is described in ``repro_torch.analysis.roofline``.
"""

from repro_torch.sim.hw import EDGE_HW, HWConfig
from repro_torch.sim.workload import (
    AttentionWorkload,
    ChunkedPrefillWorkload,
    PagedDecodeWorkload,
    SharedPrefixWorkload,
    ShardedServingWorkload,
    SpeculativeDecodeWorkload,
    PAPER_NETWORKS,
)
from repro_torch.sim.engine import simulate, SimResult
from repro_torch.sim.schedules import METHODS, build_schedule, Tiling
from repro_torch.sim.search import search_tiling

__all__ = [
    "EDGE_HW", "HWConfig", "AttentionWorkload", "ChunkedPrefillWorkload",
    "PagedDecodeWorkload", "SharedPrefixWorkload",
    "ShardedServingWorkload", "SpeculativeDecodeWorkload",
    "PAPER_NETWORKS",
    "simulate", "SimResult", "METHODS", "build_schedule", "Tiling",
    "search_tiling",
]
