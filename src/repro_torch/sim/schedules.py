"""Tiled task-graph builders for the six methods of §5.

Each builder maps (workload, tiling) -> list[Task] for ONE core (the two
cores split heads symmetrically; DRAM bandwidth is split likewise), or
returns None when the tiling is infeasible on the L1 (after the §4.3
overwrite relaxation, where applicable).

Tiling = (hh, nq, nkv): heads per stream tile (H_h), query rows per block
(N_Q), and K/V sub-matrix rows (N_{K,V}) — the paper's multi-tiered
factors with B=1.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.sim.engine import Task
from repro_torch.sim.hw import HWConfig
from repro_torch.sim.workload import (
    AttentionWorkload,
    ChunkedPrefillWorkload,
    PagedDecodeWorkload,
    SharedPrefixWorkload,
    ShardedServingWorkload,
    SpeculativeDecodeWorkload,
)

METHODS = ("layerwise", "softpipe", "flat", "tileflow", "fusemax", "mas")


@dataclasses.dataclass(frozen=True)
class Tiling:
    hh: int = 1
    nq: int = 64
    nkv: int = 256
    # KV operand width in bytes — precision as a first-class tiling
    # factor (§4.2 extended; DESIGN.md §5). None -> workload/device
    # default; 1 -> int8 KV (+ fp32 scale side-traffic, VEC dequant).
    kv_bpe: int | None = None
    # Prompt tokens per chunked-prefill engine step (DESIGN.md §6).
    # None -> monolithic (whole-prompt) admission; searched for
    # ChunkedPrefillWorkload next to kv_bpe (grid/MCTS/GA genomes carry
    # it as a fifth gene).
    chunk: int | None = None
    # Speculation depth — candidate rows per verify step (DESIGN.md §9).
    # None -> workload pin or plain decode (k=1); searched for
    # SpeculativeDecodeWorkload as the SIXTH gene: fewer serial steps
    # vs. fatter MXU/VEC tiles, with the page DMA charged once either way.
    spec: int | None = None
    # Pool fraction reserved for the shared-prefix cache (DESIGN.md §10).
    # None -> sharing off (no reserve); searched for
    # SharedPrefixWorkload as the SEVENTH gene: a resident prefix turns
    # hit admissions into suffix-only prefills, but every reserved page
    # shrinks the live pool and serializes decode into more rounds.
    cache_frac: float | None = None
    # Mesh shard degree — chips the KV heads split across (DESIGN.md
    # §11). None -> single chip; searched for ShardedServingWorkload as
    # the EIGHTH gene: per-chip compute/DMA shrink vs the per-step ring
    # all-gather on the LINK stream (hw.link_gbps / link_setup_cycles).
    shard: int | None = None


def _effective_kv_bpe(w, t: Tiling, hw: HWConfig) -> int:
    """Searched factor > workload pin > device native, in that order."""
    return t.kv_bpe or getattr(w, "kv_bpe", None) or hw.bytes_per_elem


class _Builder:
    def __init__(self, w: AttentionWorkload, t: Tiling, hw: HWConfig):
        self.w, self.t, self.hw = w, t, hw
        self.bpe = hw.bytes_per_elem
        self.kv_bpe = _effective_kv_bpe(w, t, hw)
        self.kv_quant = self.kv_bpe < self.bpe
        self.heads_core = -(-w.heads // hw.cores)
        self.hh = min(t.hh, self.heads_core)
        self.nq = min(t.nq, w.seq)
        self.nkv = min(t.nkv, w.seq)
        self.n_head_tiles = -(-self.heads_core // self.hh)
        self.tr = -(-w.seq // self.nq)   # Q row blocks per head tile
        self.tc = -(-w.seq // self.nkv)  # K/V sub-tiles
        self.dma_bpc = hw.dram_bytes_per_cycle / hw.cores
        self.tasks: list[Task] = []

    # -- primitive task emitters (return task index) --
    def _emit(self, **kw) -> int:
        self.tasks.append(Task(**kw))
        return len(self.tasks) - 1

    def dma_in(self, nbytes: int, deps=(), tag="") -> int:
        return self._emit(unit="DMA", cycles=nbytes / self.dma_bpc,
                          deps=tuple(deps), tag=tag, dram_read_bytes=nbytes,
                          l1_bytes=nbytes)

    def dma_out(self, nbytes: int, deps=(), tag="") -> int:
        return self._emit(unit="DMA", cycles=nbytes / self.dma_bpc,
                          deps=tuple(deps), tag=tag, dram_write_bytes=nbytes,
                          l1_bytes=nbytes)

    def mac_qk(self, deps, tag="C") -> int:
        """C tile: (hh x nq x E) @ (E x nkv)."""
        hh, nq, nkv, e = self.hh, self.nq, self.nkv, self.w.emb
        cyc = hh * self.hw.mac_cycles(nq, e, nkv)
        ops = hh * nq * nkv * e
        l1 = (nq * e + nkv * e + nq * nkv) * hh * self.bpe
        return self._emit(unit="MAC", cycles=cyc, deps=tuple(deps), tag=tag,
                          mac_ops=ops, l1_bytes=l1)

    def mac_pv(self, deps, tag="O") -> int:
        """O tile accumulate: (hh x nq x nkv) @ (nkv x E)."""
        hh, nq, nkv, e = self.hh, self.nq, self.nkv, self.w.emb
        cyc = hh * self.hw.mac_cycles(nq, nkv, e)
        ops = hh * nq * nkv * e
        l1 = (nq * nkv + nkv * e + nq * e) * hh * self.bpe
        return self._emit(unit="MAC", cycles=cyc, deps=tuple(deps), tag=tag,
                          mac_ops=ops, l1_bytes=l1)

    def vec_softmax(self, deps, cols=None, rows=None, tag="P",
                    mask_elems=0) -> int:
        hh, nq = self.hh, self.nq
        n = self.w.seq if cols is None else cols
        r = hh * nq if rows is None else rows
        cyc = self.hw.vec_softmax_cycles(r, n)
        ops = self.hw.vec_ops_softmax(r, n)
        if mask_elems:
            # Partial-tile causal masking charged to the VEC stream: one
            # compare+select pass over the diagonal-straddling tiles.
            cyc += mask_elems / self.hw.vec_lanes * self.hw.vec_ew_cost
            ops += mask_elems
        if self.kv_quant:
            # int8 KV dequant lands on the VEC stream (DESIGN.md §5):
            # one multiply pass applying the K scales to the score row
            # and one folding the V scales into P.
            cyc += 2 * r * n / self.hw.vec_lanes * self.hw.vec_ew_cost
            ops += 2 * r * n
        l1 = 2 * r * n * self.bpe
        return self._emit(unit="VEC", cycles=cyc, deps=tuple(deps), tag=tag,
                          vec_ops=ops, l1_bytes=l1)

    # -- causal tile pruning (DESIGN.md §3) --
    def tc_row(self, i: int) -> int:
        """KV sub-tiles intersecting Q row block i (== tc when dense)."""
        if not self.w.causal:
            return self.tc
        row_last = min((i + 1) * self.nq, self.w.seq) - 1
        return min(self.tc, row_last // self.nkv + 1)

    def cols_row(self, i: int) -> int:
        """Live score-row width for row block i (tile-granular)."""
        return min(self.w.seq, self.tc_row(i) * self.nkv)

    def mask_elems_row(self, i: int) -> int:
        """Score elements in diagonal-straddling tiles of row block i —
        the tiles whose in-tile causal mask the VEC stream must apply."""
        if not self.w.causal:
            return 0
        n_below = min(self.tc_row(i), (i * self.nq + 1) // self.nkv)
        return (self.tc_row(i) - n_below) * self.hh * self.nq * self.nkv

    def row_buf_row_b(self, i: int) -> int:
        """Live bytes of the C/P row buffer for row block i."""
        return self.hh * self.nq * self.cols_row(i) * self.bpe

    # -- tile byte sizes --
    @property
    def q_tile_b(self):  # Q_i
        return self.hh * self.nq * self.w.emb * self.bpe

    @property
    def kv_tile_b(self):  # one K or V sub-tile (+ per-row scales if int8)
        nbytes = self.hh * self.nkv * self.w.emb * self.kv_bpe
        if self.kv_quant:
            nbytes += self.hh * self.nkv * 4  # fp32 per-row scales
        return nbytes

    @property
    def kv_head_b(self):  # full K or V for a head tile
        nbytes = self.hh * self.w.seq * self.w.emb * self.kv_bpe
        if self.kv_quant:
            nbytes += self.hh * self.w.seq * 4
        return nbytes

    @property
    def row_buf_b(self):  # one C/P row buffer
        return self.hh * self.nq * self.w.seq * self.bpe

    @property
    def o_tile_b(self):
        return self.hh * self.nq * self.w.emb * self.bpe


def _rows(b: _Builder):
    for ht in range(b.n_head_tiles):
        for i in range(b.tr):
            yield ht, i


# ---------------------------------------------------------------------------
# MAS-Attention (Alg. 1): two streams, warm-up/regular/finalize, overwrite.
# ---------------------------------------------------------------------------


def build_mas(w, t, hw) -> list[Task] | None:
    b = _Builder(w, t, hw)
    qo = 2 * (b.q_tile_b + b.o_tile_b)
    rb2 = 2 * b.row_buf_b  # P_{i-1} + C_i double row buffer (§5.6 trade)
    kv_full = b.kv_head_b  # one of K / V pinned for a head tile
    if rb2 + 2 * kv_full + qo <= hw.l1_bytes:
        mode = "resident"            # ideal regime: K and V pinned
    elif rb2 + kv_full + qo <= hw.l1_bytes:
        mode = "resident_overwrite"  # §4.3 Fig.2: P_i steals V's slot;
        # K stays pinned, V reloads from DRAM each row block
    elif rb2 + 4 * b.kv_tile_b + qo <= hw.l1_bytes:
        mode = "streamed"            # fine-grained sub-tiles only
    elif rb2 + qo <= hw.l1_bytes:
        mode = "streamed_overwrite"  # stream + stall/reload/redo
    else:
        return None  # §5.6: even two row buffers overflow L1
    overwrite = mode.endswith("overwrite")
    k_resident = mode in ("resident", "resident_overwrite")
    v_resident = mode == "resident"

    rows = list(_rows(b))
    c_last: dict[int, int] = {}   # row -> last C MAC task
    p_task: dict[int, int] = {}   # row -> softmax task
    o_last: dict[int, int] = {}   # row -> last O MAC task
    kv_loaded: dict[int, list[int]] = {}  # head tile -> K dma tasks

    def load_kv(ht, which, resident_flag, count) -> list[int]:
        if resident_flag:
            # The pinned matrix is loaded whole once per head tile (the
            # last causal row block needs every tile anyway).
            key = (ht, which)
            if key not in kv_loaded:
                kv_loaded[key] = [
                    b.dma_in(b.kv_tile_b, tag=f"{which}{ht}.{j}")
                    for j in range(b.tc)
                ]
            return kv_loaded[key]
        return [b.dma_in(b.kv_tile_b, tag=f"{which}{ht}.{j}")
                for j in range(count)]

    def emit_c(r):
        ht, i = rows[r]
        tc = b.tc_row(i)  # causal: only intersecting KV tiles
        qd = b.dma_in(b.q_tile_b, tag=f"Q{r}")
        kds = load_kv(ht, "K", k_resident, tc)
        # Two row buffers: C_r reuses row r-2's buffer, freed by O_{r-2}.
        buf = [o_last[r - 2]] if r - 2 in o_last else []
        last = None
        for j in range(tc):
            last = b.mac_qk(deps=[qd, kds[j]] + buf, tag=f"C{r}.{j}")
        c_last[r] = last

    def emit_p(r):
        _, i = rows[r]
        p_task[r] = b.vec_softmax(deps=[c_last[r]], cols=b.cols_row(i),
                                  mask_elems=b.mask_elems_row(i), tag=f"P{r}")

    def emit_o(r):
        ht, i = rows[r]
        tc = b.tc_row(i)
        if overwrite:
            # §4.3: V was overwritten so P_r could finish — the MAC
            # stream stalls on the softmax, then V reloads from DRAM
            # and the interrupted MatMul redoes its (live) tiles.
            vds = [b.dma_in(b.kv_tile_b, deps=[p_task[r]],
                            tag=f"Vreload{r}.{j}") for j in range(tc)]
        else:
            vds = load_kv(ht, "V", v_resident, tc)
        last = None
        for j in range(tc):
            last = b.mac_pv(deps=[p_task[r], vds[j]], tag=f"O{r}.{j}")
        o_last[r] = last
        b.dma_out(b.o_tile_b, deps=[last], tag=f"Oout{r}")

    # Alg. 1 issue order on the MAC queue: C1, C2, then (O_{i-2}, C_i)...
    n = len(rows)
    if n == 1:
        emit_c(0); emit_p(0); emit_o(0)
    else:
        emit_c(0)
        emit_c(1)
        emit_p(0)
        for i in range(2, n):
            emit_o(i - 2)
            emit_p(i - 1)
            emit_c(i)
        emit_o(n - 2)
        emit_p(n - 1)
        emit_o(n - 1)
    return b.tasks


# ---------------------------------------------------------------------------
# FLAT: fused, on-chip, strictly sequential tile stages (C_i -> P_i -> O_i).
# ---------------------------------------------------------------------------


def build_flat(w, t, hw) -> list[Task] | None:
    b = _Builder(w, t, hw)
    qo = 2 * (b.q_tile_b + b.o_tile_b)
    resident = b.row_buf_b + 2 * b.kv_head_b + qo <= hw.l1_bytes
    streamed = b.row_buf_b + 4 * b.kv_tile_b + qo <= hw.l1_bytes
    if not (resident or streamed):
        return None

    kv_loaded: dict = {}

    def load_kv(ht, which, count):
        if resident:
            key = (ht, which)
            if key not in kv_loaded:
                kv_loaded[key] = [b.dma_in(b.kv_tile_b) for _ in range(b.tc)]
            return kv_loaded[key]
        return [b.dma_in(b.kv_tile_b) for _ in range(count)]

    prev_o = None  # strict stage chain: C_{i+1} starts after O_i finishes
    for ht, i in _rows(b):
        tc = b.tc_row(i)
        qd = b.dma_in(b.q_tile_b)
        kds = load_kv(ht, "K", tc)
        last = None
        for j in range(tc):
            deps = [qd, kds[j]] + ([prev_o] if prev_o is not None else [])
            last = b.mac_qk(deps=deps)
        p = b.vec_softmax(deps=[last], cols=b.cols_row(i),
                          mask_elems=b.mask_elems_row(i))
        vds = load_kv(ht, "V", tc)
        last_o = None
        for j in range(tc):
            last_o = b.mac_pv(deps=[p, vds[j]])
        prev_o = last_o
        b.dma_out(b.o_tile_b, deps=[last_o])
    return b.tasks


# ---------------------------------------------------------------------------
# Layer-Wise: unfused; C and P round-trip DRAM; operator barriers.
# ---------------------------------------------------------------------------


def build_layerwise(w, t, hw) -> list[Task] | None:
    b = _Builder(w, t, hw)
    if b.row_buf_b + 4 * b.kv_tile_b + 2 * b.q_tile_b > hw.l1_bytes:
        return None
    barrier: list[int] = []

    # Stage 1: C = QK^T, spill C to DRAM (live causal columns only)
    stage: list[int] = []
    for ht, i in _rows(b):
        qd = b.dma_in(b.q_tile_b)
        last = None
        for j in range(b.tc_row(i)):
            kd = b.dma_in(b.kv_tile_b)
            last = b.mac_qk(deps=[qd, kd])
        stage.append(b.dma_out(b.row_buf_row_b(i), deps=[last], tag="Cout"))
    barrier = stage

    # Stage 2: P = softmax(C), C from DRAM, P to DRAM
    stage = []
    for ht, i in _rows(b):
        cd = b.dma_in(b.row_buf_row_b(i), deps=barrier, tag="Cin")
        p = b.vec_softmax(deps=[cd], cols=b.cols_row(i),
                          mask_elems=b.mask_elems_row(i))
        stage.append(b.dma_out(b.row_buf_row_b(i), deps=[p], tag="Pout"))
    barrier = stage

    # Stage 3: O = PV, P from DRAM
    for ht, i in _rows(b):
        pd = b.dma_in(b.row_buf_row_b(i), deps=barrier, tag="Pin")
        last = None
        for j in range(b.tc_row(i)):
            vd = b.dma_in(b.kv_tile_b)
            last = b.mac_pv(deps=[pd, vd])
        b.dma_out(b.o_tile_b, deps=[last])
    return b.tasks


# ---------------------------------------------------------------------------
# Soft-Pipe: pipelines QK^T with softmax; P round-trips DRAM; PV sequential.
# ---------------------------------------------------------------------------


def build_softpipe(w, t, hw) -> list[Task] | None:
    b = _Builder(w, t, hw)
    if 2 * b.row_buf_b + 4 * b.kv_tile_b + 2 * b.q_tile_b > hw.l1_bytes:
        return None
    pouts: list[int] = []
    for ht, i in _rows(b):
        qd = b.dma_in(b.q_tile_b)
        last = None
        for j in range(b.tc_row(i)):
            kd = b.dma_in(b.kv_tile_b)
            last = b.mac_qk(deps=[qd, kd])
        p = b.vec_softmax(deps=[last], cols=b.cols_row(i),
                          mask_elems=b.mask_elems_row(i))
        pouts.append(b.dma_out(b.row_buf_row_b(i), deps=[p], tag="Pout"))
    for ht, i in _rows(b):
        pd = b.dma_in(b.row_buf_row_b(i), deps=pouts, tag="Pin")
        last = None
        for j in range(b.tc_row(i)):
            vd = b.dma_in(b.kv_tile_b)
            last = b.mac_pv(deps=[pd, vd])
        b.dma_out(b.o_tile_b, deps=[last])
    return b.tasks


# ---------------------------------------------------------------------------
# TileFlow-style: fused + pipelined tree dataflow, but (a) no H_h tier
# (single fusion level: heads processed one at a time), (b) no K/V
# sub-matrix tier, (c) single score buffer — C_{i+1} must wait for P_i to
# release it — and (d) no overwrite relaxation. These are exactly the
# pieces MAS adds (multi-tier tiling + double row buffer + §4.3).
# ---------------------------------------------------------------------------


def build_tileflow(w, t, hw) -> list[Task] | None:
    t1 = Tiling(hh=1, nq=t.nq, nkv=w.seq)  # tiers collapsed
    b = _Builder(w, t1, hw)
    qo = 2 * (b.q_tile_b + b.o_tile_b)
    if b.row_buf_b + 2 * b.kv_head_b + qo > hw.l1_bytes:
        return None  # no overwrite escape hatch
    kv_loaded: dict = {}

    def load_kv(ht, which):
        key = (ht, which)
        if key not in kv_loaded:
            kv_loaded[key] = [b.dma_in(b.kv_tile_b)]
        return kv_loaded[key]

    rows = list(_rows(b))
    c_last, p_task = {}, {}

    def emit_c(r):
        ht, _ = rows[r]
        qd = b.dma_in(b.q_tile_b)
        kd = load_kv(ht, "K")[0]
        deps = [qd, kd]
        if r - 1 in p_task:
            deps.append(p_task[r - 1])  # single buffer: wait for release
        c_last[r] = b.mac_qk(deps=deps)

    def emit_p(r):
        # No K/V sub-tile tier: the single row-wide tile always straddles
        # the diagonal, so causal workloads mask the WHOLE row (no pruning
        # available — exactly the tier MAS adds).
        full_row = b.hh * b.nq * b.w.seq if w.causal else 0
        p_task[r] = b.vec_softmax(deps=[c_last[r]], mask_elems=full_row)

    def emit_o(r):
        ht, _ = rows[r]
        vd = load_kv(ht, "V")[0]
        last = b.mac_pv(deps=[p_task[r], vd])
        b.dma_out(b.o_tile_b, deps=[last])

    n = len(rows)
    if n == 1:
        emit_c(0); emit_p(0); emit_o(0)
    else:
        emit_c(0)
        emit_p(0)
        emit_c(1)
        for i in range(2, n):
            emit_o(i - 2); emit_p(i - 1); emit_c(i)
        emit_o(n - 2); emit_p(n - 1); emit_o(n - 1)
    return b.tasks


# ---------------------------------------------------------------------------
# FuseMax-style: online-softmax einsum cascade, MAC/VEC pipelined per
# kv tile; fixed (manually chosen) tiling — the caller pins Tiling. The
# 12-primitive einsum decomposition runs each softmax sub-op as a separate
# un-fused VEC pass (extra passes over the tile + running-stat updates),
# modeled as a 2x VEC-pass multiplier.
# ---------------------------------------------------------------------------

FUSEMAX_VEC_PASSES = 2.0


def build_fusemax(w, t, hw) -> list[Task] | None:
    b = _Builder(w, t, hw)
    qo = 2 * (b.q_tile_b + b.o_tile_b)
    # online softmax: only (nq, nkv) score tiles live on-chip
    tile_buf = 2 * b.hh * b.nq * b.nkv * b.bpe
    resident = tile_buf + 2 * b.kv_head_b + qo <= hw.l1_bytes
    if not resident and tile_buf + 4 * b.kv_tile_b + qo > hw.l1_bytes:
        return None
    kv_loaded: dict = {}

    def load_kv(ht, which, j):
        if resident:
            key = (ht, which)
            if key not in kv_loaded:
                kv_loaded[key] = [b.dma_in(b.kv_tile_b) for _ in range(b.tc)]
            return kv_loaded[key][j]
        return b.dma_in(b.kv_tile_b)
    def vec_partial(c_dep, i, j, masked):
        # partial softmax on the tile + running (m, l) + acc rescale
        r = b.hh * b.nq
        cyc = FUSEMAX_VEC_PASSES * hw.vec_softmax_cycles(r, b.nkv) + r * (
            2 * hw.vec_ew_cost + w.emb / hw.vec_lanes * 2
        )
        ops = hw.vec_ops_softmax(r, b.nkv) + 2 * r * w.emb
        if masked:
            # diagonal-straddling tile: one causal compare+select pass
            cyc += r * b.nkv / hw.vec_lanes * hw.vec_ew_cost
            ops += r * b.nkv
        if b.kv_quant:
            # int8 dequant: K scales on the score tile + V fold into P
            cyc += 2 * r * b.nkv / hw.vec_lanes * hw.vec_ew_cost
            ops += 2 * r * b.nkv
        return b._emit(unit="VEC", cycles=cyc, deps=(c_dep,),
                       tag=f"p{i}.{j}", vec_ops=ops,
                       l1_bytes=2 * r * b.nkv * b.bpe)

    for ht, i in _rows(b):
        # Software-pipelined einsum cascade: the MAC queue runs
        # S_{j+1} ahead of A_j so the VEC partial-softmax overlaps.
        # Causal: only tiles intersecting the diagonal are emitted.
        tc = b.tc_row(i)
        n_below = (i * b.nq + 1) // b.nkv  # strictly-below tiles: no mask
        qd = b.dma_in(b.q_tile_b)
        s_tasks, p_tasks = [], []

        def emit_s(j):
            kd = load_kv(ht, "K", j)
            s_tasks.append(b.mac_qk(deps=[qd, kd], tag=f"S{i}.{j}"))
            p_tasks.append(
                vec_partial(s_tasks[-1], i, j, w.causal and j >= n_below)
            )

        prev_acc = None

        def emit_a(j):
            nonlocal prev_acc
            vd = load_kv(ht, "V", j)
            deps = [p_tasks[j], vd] + (
                [prev_acc] if prev_acc is not None else []
            )
            prev_acc = b.mac_pv(deps=deps, tag=f"A{i}.{j}")

        emit_s(0)
        for j in range(1, tc):
            emit_s(j)
            emit_a(j - 1)
        emit_a(tc - 1)
        b.dma_out(b.o_tile_b, deps=[prev_acc])
    return b.tasks


# ---------------------------------------------------------------------------
# Paged decode: one continuous-batching step; KV gathered page by page.
# ---------------------------------------------------------------------------


def build_paged_decode(w, t, hw) -> list[Task] | None:
    """Task graph for one paged decode step (PagedDecodeWorkload).

    ``t.nkv`` is the PAGE SIZE — the tiling factor the search sweeps —
    and ``t.hh`` the kv-head tile; ``t.nq`` is ignored (the MXU row dim
    is the fixed GQA group). ``t.kv_bpe`` (or the workload's pin) sets
    the KV element width: int8 pages halve/quarter the page DMA bytes,
    add one fp32 scale per page (K and V each) to that DMA, and charge
    two dequant multiply passes on the VEC stream (DESIGN.md §5). Per
    live page: one K-page DMA (descriptor setup + page bytes, partial
    pages charged whole), a (group x page) QK^T MAC, a fusemax-style
    partial-softmax VEC pass, one V-page DMA and the PV accumulate —
    MAC/VEC pipelined across pages exactly like the online-softmax
    decode kernel.
    """
    page = min(t.nkv, w.seq)
    heads_core = -(-w.heads // hw.cores)
    hh = min(t.hh, heads_core)
    bpe = hw.bytes_per_elem
    kv_bpe = _effective_kv_bpe(w, t, hw)
    kv_quant = kv_bpe < bpe
    g, e = w.group, w.emb
    # L1: Q + O + double-buffered K/V pages + the (g, page) score tile
    need = (hh * (2 * g * e + 2 * g * page) * bpe
            + hh * 4 * page * e * kv_bpe)
    if need > hw.l1_bytes:
        return None

    dma_bpc = hw.dram_bytes_per_cycle / hw.cores
    tasks: list[Task] = []

    def emit(**kw) -> int:
        tasks.append(Task(**kw))
        return len(tasks) - 1

    def dma_page(nbytes, deps=(), tag=""):
        return emit(unit="DMA",
                    cycles=hw.dma_page_setup_cycles + nbytes / dma_bpc,
                    deps=tuple(deps), tag=tag, dram_read_bytes=nbytes,
                    l1_bytes=nbytes)

    page_b = hh * page * e * kv_bpe + (hh * 4 if kv_quant else 0)
    q_b = hh * g * e * bpe

    for s, kv_len in enumerate(w.kv_lens):
        n_pages = -(-kv_len // page)
        for ht in range(-(-heads_core // hh)):
            qd = emit(unit="DMA", cycles=q_b / dma_bpc, tag=f"Q{s}.{ht}",
                      dram_read_bytes=q_b, l1_bytes=q_b)
            prev_acc = None
            for j in range(n_pages):
                kd = dma_page(page_b, tag=f"K{s}.{ht}.{j}")
                sj = emit(unit="MAC", cycles=hh * hw.mac_cycles(g, e, page),
                          deps=(qd, kd), tag=f"S{s}.{ht}.{j}",
                          mac_ops=hh * g * page * e,
                          l1_bytes=(g * e + page * e + g * page) * hh * bpe)
                # partial softmax + running (m, l) + acc rescale
                r = hh * g
                cyc = hw.vec_softmax_cycles(r, page) + r * (
                    2 * hw.vec_ew_cost + e / hw.vec_lanes * 2
                )
                ops = hw.vec_ops_softmax(r, page) + 2 * r * e
                if kv_quant:
                    # dequant on the VEC stream: page scale applied to
                    # the (g, page) score tile + folded into P
                    cyc += 2 * r * page / hw.vec_lanes * hw.vec_ew_cost
                    ops += 2 * r * page
                pj = emit(unit="VEC", cycles=cyc, deps=(sj,),
                          tag=f"P{s}.{ht}.{j}",
                          vec_ops=ops,
                          l1_bytes=2 * r * page * bpe)
                vd = dma_page(page_b, tag=f"V{s}.{ht}.{j}")
                deps = [pj, vd] + ([prev_acc] if prev_acc is not None else [])
                prev_acc = emit(unit="MAC",
                                cycles=hh * hw.mac_cycles(g, page, e),
                                deps=tuple(deps), tag=f"A{s}.{ht}.{j}",
                                mac_ops=hh * g * page * e,
                                l1_bytes=(g * page + page * e + g * e)
                                * hh * bpe)
            emit(unit="DMA", cycles=q_b / dma_bpc, deps=(prev_acc,),
                 tag=f"O{s}.{ht}", dram_write_bytes=q_b, l1_bytes=q_b)
    return tasks


# ---------------------------------------------------------------------------
# Speculative decode: verify steps of k candidate rows, serial until the
# token goal is met; step count scales with the expected acceptance.
# ---------------------------------------------------------------------------


def build_speculative_decode(w, t, hw) -> list[Task] | None:
    """Task graph for a speculative generation (SpeculativeDecodeWorkload).

    ``t.spec`` is the SPECULATION DEPTH — the sixth searchable factor
    (DESIGN.md §9; falls back to the workload pin, then k=1) — ``t.nkv``
    the page size, ``t.hh`` the kv-head tile, ``t.kv_bpe`` the KV
    element width; ``t.nq``/``t.chunk`` are ignored. The schedule emits
    ``w.n_steps(spec)`` SERIAL verify steps (the engine's jitted
    dispatch barrier): per step and sequence the page-granular KV DMA is
    charged ONCE — candidate rows ride the same gather — while the QK^T
    and PV MACs carry (group * spec) rows and the VEC partial softmax
    covers spec score rows per query head, plus the three-band in-tile
    causal select on the diagonal-straddling pages (the k-block tail)
    and the int8 dequant passes when quantized. Depth therefore buys
    fewer steps (fewer page walks, fewer step barriers) at fatter
    per-step MXU/VEC tiles — the trade the search resolves. Host-side
    drafting (``serving.drafter``) is free.
    """
    page = min(t.nkv, w.seq)
    spec = t.spec or w.spec or 1
    heads_core = -(-w.heads // hw.cores)
    hh = min(t.hh, heads_core)
    bpe = hw.bytes_per_elem
    kv_bpe = _effective_kv_bpe(w, t, hw)
    kv_quant = kv_bpe < bpe
    g, e = w.group, w.emb
    rows_t = g * spec              # MXU row dim per kv head
    # L1: Q + O (spec rows each) + double-buffered K/V pages + score tile
    need = (hh * (2 * rows_t * e + 2 * rows_t * page) * bpe
            + hh * 4 * page * e * kv_bpe)
    if need > hw.l1_bytes:
        return None

    dma_bpc = hw.dram_bytes_per_cycle / hw.cores
    tasks: list[Task] = []

    def emit(**kw) -> int:
        tasks.append(Task(**kw))
        return len(tasks) - 1

    def dma_page(nbytes, deps=(), tag=""):
        return emit(unit="DMA",
                    cycles=hw.dma_page_setup_cycles + nbytes / dma_bpc,
                    deps=tuple(deps), tag=tag, dram_read_bytes=nbytes,
                    l1_bytes=nbytes)

    page_b = hh * page * e * kv_bpe + (hh * 4 if kv_quant else 0)
    q_b = hh * rows_t * e * bpe
    r = hh * rows_t                # VEC softmax rows per core

    prev_step: tuple[int, ...] = ()
    for st in range(w.n_steps(spec)):
        step_sinks: list[int] = []
        for s, kv_len in enumerate(w.kv_lens):
            n_pages = -(-kv_len // page)
            # diagonal-straddling pages: those covering the k candidate
            # positions [kv_len - spec, kv_len) pay the in-tile causal
            # select on the VEC stream (kernels/common.three_band_select)
            n_full = max(0, min(n_pages, (kv_len - spec) // page))
            for ht in range(-(-heads_core // hh)):
                qd = emit(unit="DMA", cycles=q_b / dma_bpc, deps=prev_step,
                          tag=f"Q{st}.{s}.{ht}", dram_read_bytes=q_b,
                          l1_bytes=q_b)
                prev_acc = None
                for j in range(n_pages):
                    kd = dma_page(page_b, deps=prev_step,
                                  tag=f"K{st}.{s}.{ht}.{j}")
                    sj = emit(unit="MAC",
                              cycles=hh * hw.mac_cycles(rows_t, e, page),
                              deps=(qd, kd), tag=f"S{st}.{s}.{ht}.{j}",
                              mac_ops=hh * rows_t * page * e,
                              l1_bytes=(rows_t * e + page * e
                                        + rows_t * page) * hh * bpe)
                    # partial softmax + running (m, l) + acc rescale
                    cyc = hw.vec_softmax_cycles(r, page) + r * (
                        2 * hw.vec_ew_cost + e / hw.vec_lanes * 2
                    )
                    ops = hw.vec_ops_softmax(r, page) + 2 * r * e
                    if j >= n_full:
                        # three-band diagonal tile: compare+select pass
                        cyc += r * page / hw.vec_lanes * hw.vec_ew_cost
                        ops += r * page
                    if kv_quant:
                        cyc += 2 * r * page / hw.vec_lanes * hw.vec_ew_cost
                        ops += 2 * r * page
                    pj = emit(unit="VEC", cycles=cyc, deps=(sj,),
                              tag=f"P{st}.{s}.{ht}.{j}", vec_ops=ops,
                              l1_bytes=2 * r * page * bpe)
                    vd = dma_page(page_b, deps=prev_step,
                                  tag=f"V{st}.{s}.{ht}.{j}")
                    deps = [pj, vd] + (
                        [prev_acc] if prev_acc is not None else [])
                    prev_acc = emit(unit="MAC",
                                    cycles=hh * hw.mac_cycles(rows_t, page,
                                                              e),
                                    deps=tuple(deps),
                                    tag=f"A{st}.{s}.{ht}.{j}",
                                    mac_ops=hh * rows_t * page * e,
                                    l1_bytes=(rows_t * page + page * e
                                              + rows_t * e) * hh * bpe)
                step_sinks.append(
                    emit(unit="DMA", cycles=q_b / dma_bpc, deps=(prev_acc,),
                         tag=f"O{st}.{s}.{ht}", dram_write_bytes=q_b,
                         l1_bytes=q_b))
        prev_step = tuple(step_sinks)
    return tasks


# ---------------------------------------------------------------------------
# Sharded serving: per-chip paged decode + per-step ring all-gather on the
# LINK stream; serial steps so the collective gates the next step.
# ---------------------------------------------------------------------------


def build_sharded_serving(w, t, hw) -> list[Task] | None:
    """Task graph for ONE CHIP of a KV-head-sharded serving mesh
    (ShardedServingWorkload, DESIGN.md §11).

    ``t.shard`` is the SHARD DEGREE — the eighth searchable factor
    (falls back to the workload pin, then 1) — ``t.nkv`` the page size,
    ``t.hh`` the kv-head tile, ``t.kv_bpe`` the KV element width;
    ``t.nq``/``t.chunk``/``t.spec``/``t.cache_frac`` are ignored. The
    chip owns ``heads / shard`` KV heads of the paged pool, so each of
    the ``w.n_steps`` serial decode steps emits the per-chip slice of
    ``build_paged_decode``'s page-walk pipeline, then ``shard - 1``
    serial ring hops on the LINK stream (per hop:
    ``hw.link_setup_cycles`` + one chip's head-output slice over
    ``hw.link_gbps``) that every next-step task depends on — the
    replicated output projection cannot start until the all-gather
    lands. Sharding therefore buys per-chip MAC/VEC/DMA shrink (until
    ``heads/shard`` drops below the chip's core count and the split
    plateaus) at per-step collective growth, which is exactly the
    "how many chips before the collective dominates" trade the search
    resolves: near-zero ``link_gbps`` collapses to one chip, fat links
    buy chips until the plateau.
    """
    page = min(t.nkv, w.seq)
    shard = t.shard or w.shard or 1
    if shard < 1 or w.heads % shard:
        return None  # degree must divide the KV heads
    heads_chip = w.heads // shard
    heads_core = -(-heads_chip // hw.cores)
    hh = min(t.hh, heads_core)
    bpe = hw.bytes_per_elem
    kv_bpe = _effective_kv_bpe(w, t, hw)
    kv_quant = kv_bpe < bpe
    g, e = w.group, w.emb
    # L1: Q + O + double-buffered K/V pages + the (g, page) score tile
    need = (hh * (2 * g * e + 2 * g * page) * bpe
            + hh * 4 * page * e * kv_bpe)
    if need > hw.l1_bytes:
        return None

    dma_bpc = hw.dram_bytes_per_cycle / hw.cores
    link_bpc = hw.link_bytes_per_cycle
    tasks: list[Task] = []

    def emit(**kw) -> int:
        tasks.append(Task(**kw))
        return len(tasks) - 1

    def dma_page(nbytes, deps=(), tag=""):
        return emit(unit="DMA",
                    cycles=hw.dma_page_setup_cycles + nbytes / dma_bpc,
                    deps=tuple(deps), tag=tag, dram_read_bytes=nbytes,
                    l1_bytes=nbytes)

    page_b = hh * page * e * kv_bpe + (hh * 4 if kv_quant else 0)
    q_b = hh * g * e * bpe
    # one ring hop moves one chip's slice of the (batch, Hq, E) head
    # outputs; shard - 1 hops land the full gather on every chip
    hop_b = w.gather_bytes(shard) // max(1, shard - 1) if shard > 1 else 0

    prev_step: tuple[int, ...] = ()
    for st in range(w.n_steps):
        step_sinks: list[int] = []
        for s, kv_len in enumerate(w.kv_lens):
            n_pages = -(-kv_len // page)
            for ht in range(-(-heads_core // hh)):
                qd = emit(unit="DMA", cycles=q_b / dma_bpc, deps=prev_step,
                          tag=f"Q{st}.{s}.{ht}", dram_read_bytes=q_b,
                          l1_bytes=q_b)
                prev_acc = None
                for j in range(n_pages):
                    kd = dma_page(page_b, deps=prev_step,
                                  tag=f"K{st}.{s}.{ht}.{j}")
                    sj = emit(unit="MAC",
                              cycles=hh * hw.mac_cycles(g, e, page),
                              deps=(qd, kd), tag=f"S{st}.{s}.{ht}.{j}",
                              mac_ops=hh * g * page * e,
                              l1_bytes=(g * e + page * e + g * page)
                              * hh * bpe)
                    # partial softmax + running (m, l) + acc rescale
                    r = hh * g
                    cyc = hw.vec_softmax_cycles(r, page) + r * (
                        2 * hw.vec_ew_cost + e / hw.vec_lanes * 2
                    )
                    ops = hw.vec_ops_softmax(r, page) + 2 * r * e
                    if kv_quant:
                        cyc += 2 * r * page / hw.vec_lanes * hw.vec_ew_cost
                        ops += 2 * r * page
                    pj = emit(unit="VEC", cycles=cyc, deps=(sj,),
                              tag=f"P{st}.{s}.{ht}.{j}", vec_ops=ops,
                              l1_bytes=2 * r * page * bpe)
                    vd = dma_page(page_b, deps=prev_step,
                                  tag=f"V{st}.{s}.{ht}.{j}")
                    deps = [pj, vd] + (
                        [prev_acc] if prev_acc is not None else [])
                    prev_acc = emit(unit="MAC",
                                    cycles=hh * hw.mac_cycles(g, page, e),
                                    deps=tuple(deps),
                                    tag=f"A{st}.{s}.{ht}.{j}",
                                    mac_ops=hh * g * page * e,
                                    l1_bytes=(g * page + page * e + g * e)
                                    * hh * bpe)
                step_sinks.append(
                    emit(unit="DMA", cycles=q_b / dma_bpc, deps=(prev_acc,),
                         tag=f"O{st}.{s}.{ht}", dram_write_bytes=q_b,
                         l1_bytes=q_b))
        # ring all-gather of the step's head outputs: shard - 1 SERIAL
        # hops on the LINK stream, gating everything in the next step
        prev = tuple(step_sinks)
        for hop in range(shard - 1):
            prev = (emit(unit="LINK",
                         cycles=hw.link_setup_cycles + hop_b / link_bpc,
                         deps=prev, tag=f"G{st}.{hop}"),)
        prev_step = prev
    return tasks


# ---------------------------------------------------------------------------
# Chunked paged prefill: admit one prompt in chunks, decode interleaved.
# ---------------------------------------------------------------------------


def build_chunked_prefill(w, t, hw) -> list[Task] | None:
    """Task graph for admitting one prompt in chunks (DESIGN.md §6).

    ``t.chunk`` is the CHUNK SIZE — the searchable factor (None ->
    monolithic whole-prompt admission) — ``t.nkv`` the page size,
    ``t.hh`` the kv-head tile (head tiles run back to back within a
    step) and ``t.nq`` is ignored (the MXU row dim is group * chunk).
    Per chunk and head tile: Q in, page-granular KV-read
    DMA for ALL prior context plus the chunk itself (the re-read that
    bigger chunks amortize — each page DMA pays
    ``hw.dma_page_setup_cycles``), the (group*chunk x page) QK^T MACs
    with the §3 three-band split (fully-visible pages aggregate into
    one bulk task; diagonal-straddling pages are masked per page on the
    VEC stream), ONE row-granularity softmax over the visible columns
    (Alg. 3 — which is exactly what bounds the chunk: the §5.6 double
    row buffer must hold (group*chunk x visible) score rows in L1, so
    whole-prompt admission of a long prompt is infeasible and the
    search is forced to a finite chunk), the PV MACs, the chunk's own
    K/V page WRITES (plus a quantize VEC pass for int8 pools), and then
    one decode step over ``w.decode_kv_lens`` — the engine's
    token-budget rule: live decode slots advance once per chunk.
    Steps serialize like the engine's jitted dispatch.
    """
    page = min(t.nkv, w.prompt)
    chunk = w.prompt if t.chunk is None else min(t.chunk, w.prompt)
    if chunk % page and chunk != w.prompt:
        return None  # engine invariant: chunks are page-aligned
    bpe = hw.bytes_per_elem
    kv_bpe = _effective_kv_bpe(w, t, hw)
    kv_quant = kv_bpe < bpe
    heads_core = -(-w.heads // hw.cores)
    hh = min(t.hh, heads_core)
    n_head_tiles = -(-heads_core // hh)
    g, e = w.group, w.emb
    rows = hh * g * chunk
    visible_max = -(-w.prompt // page) * page
    # §5.6 L1 bound: double row buffer + double-buffered K/V pages + Q/O
    need = (2 * rows * visible_max * bpe
            + hh * 4 * page * e * kv_bpe
            + 2 * hh * g * chunk * e * bpe)
    if need > hw.l1_bytes:
        return None

    dma_bpc = hw.dram_bytes_per_cycle / hw.cores
    tasks: list[Task] = []

    def emit(**kw) -> int:
        tasks.append(Task(**kw))
        return len(tasks) - 1

    def dma_pages(n, deps=(), tag="", write=False) -> int:
        nbytes = n * page_b
        kw = {"dram_write_bytes" if write else "dram_read_bytes": nbytes}
        return emit(unit="DMA",
                    cycles=n * hw.dma_page_setup_cycles + nbytes / dma_bpc,
                    deps=tuple(deps), tag=tag, l1_bytes=nbytes, **kw)

    page_b = hh * page * e * kv_bpe + (hh * 4 if kv_quant else 0)
    q_b = rows * e * bpe

    def mac(m, k, n, deps, tag) -> int:
        return emit(unit="MAC", cycles=hh * hw.mac_cycles(m, k, n),
                    deps=tuple(deps), tag=tag, mac_ops=hh * m * k * n,
                    l1_bytes=(m * k + k * n + m * n) * hh * bpe)

    n_chunks = -(-w.prompt // chunk)
    # Preemption churn (DESIGN.md §7): a preempted request replays its
    # admission chunk by chunk, so an expected preempt_rate recomputes
    # per prompt charge ceil(rate * n_chunks) extra chunk steps — same
    # prior-context re-read, page re-write and interleaved decode as the
    # first pass. The replay samples the TAIL chunks (deepest context):
    # a tail fraction f of the causal triangle covers f*(2-f) >= f of
    # its area, so the scheduled charge stays an upper bound on the
    # workload's rate-scaled useful-MAC floor for any chunk size.
    rate = getattr(w, "preempt_rate", 0.0)
    n_recompute = math.ceil(rate * n_chunks) if rate > 0 else 0
    prev_step: tuple[int, ...] = ()
    for ci in range(n_chunks + n_recompute):
        if ci < n_chunks:
            q0 = ci * chunk
        else:
            q0 = (n_chunks - 1 - (ci - n_chunks) % n_chunks) * chunk
        kv_len = min(q0 + chunk, w.prompt)
        n_needed = -(-kv_len // page)
        n_full = min((q0 + 1) // page, n_needed)
        rows_t = g * chunk
        step_sinks: list[int] = []
        for ht in range(n_head_tiles):
            qd = emit(unit="DMA", cycles=q_b / dma_bpc, deps=prev_step,
                      tag=f"Q{ci}.{ht}", dram_read_bytes=q_b, l1_bytes=q_b)
            # fully-visible band aggregates into one bulk DMA+MAC pair
            # (same bytes, same per-page descriptor cycles); only the
            # straddling pages stay per-page for the in-tile mask
            c_tasks = []
            if n_full:
                kd = dma_pages(n_full, deps=prev_step, tag=f"K{ci}.{ht}b")
                c_tasks.append(mac(rows_t, e, n_full * page, (qd, kd),
                                   f"C{ci}.{ht}b"))
            for j in range(n_full, n_needed):
                kd = dma_pages(1, deps=prev_step, tag=f"K{ci}.{ht}.{j}")
                c_tasks.append(mac(rows_t, e, page, (qd, kd),
                                   f"C{ci}.{ht}.{j}"))
            # Alg. 3 row-granularity softmax over the visible columns;
            # straddling pages pay the causal select, int8 the dequant
            cols = n_needed * page
            cyc = hw.vec_softmax_cycles(rows, cols)
            ops = hw.vec_ops_softmax(rows, cols)
            mask_elems = (n_needed - n_full) * rows * page
            cyc += mask_elems / hw.vec_lanes * hw.vec_ew_cost
            ops += mask_elems
            if kv_quant:
                cyc += 2 * rows * cols / hw.vec_lanes * hw.vec_ew_cost
                ops += 2 * rows * cols
            p = emit(unit="VEC", cycles=cyc, deps=tuple(c_tasks),
                     tag=f"P{ci}.{ht}", vec_ops=ops,
                     l1_bytes=2 * rows * cols * bpe)
            o_last = None
            if n_full:
                vd = dma_pages(n_full, deps=prev_step, tag=f"V{ci}.{ht}b")
                o_last = mac(rows_t, n_full * page, e, (p, vd),
                             f"O{ci}.{ht}b")
            for j in range(n_full, n_needed):
                vd = dma_pages(1, deps=prev_step, tag=f"V{ci}.{ht}.{j}")
                deps = (p, vd) + ((o_last,) if o_last is not None else ())
                o_last = mac(rows_t, page, e, deps, f"O{ci}.{ht}.{j}")
            o_out = emit(unit="DMA", cycles=q_b / dma_bpc, deps=(o_last,),
                         tag=f"Oout{ci}.{ht}", dram_write_bytes=q_b,
                         l1_bytes=q_b)
            # the chunk's own K/V pages written back (int8: quantized)
            n_cp = -(-(kv_len - q0) // page)
            wdeps: tuple[int, ...] = prev_step
            if kv_quant:
                elems = 2 * hh * chunk * e
                wdeps = (emit(unit="VEC", tag=f"quant{ci}.{ht}",
                              deps=prev_step,
                              cycles=2 * elems / hw.vec_lanes
                              * hw.vec_ew_cost,
                              vec_ops=2 * elems, l1_bytes=2 * elems * bpe),)
            step_sinks += [o_out] + [
                dma_pages(n_cp, deps=wdeps, tag=f"{which}w{ci}.{ht}",
                          write=True) for which in ("K", "V")
            ]
        # token-budget rule: one decode step over the live slots,
        # dispatched after the chunk (the engine's single jitted step)
        dec_barrier = tuple(step_sinks)
        dq_b = hh * g * e * bpe
        for s, kv_d in enumerate(w.decode_kv_lens):
            n_pd = -(-kv_d // page)
            for ht in range(n_head_tiles):
                qdd = emit(unit="DMA", cycles=dq_b / dma_bpc,
                           deps=dec_barrier, tag=f"dQ{ci}.{s}.{ht}",
                           dram_read_bytes=dq_b, l1_bytes=dq_b)
                kdd = dma_pages(n_pd, deps=dec_barrier,
                                tag=f"dK{ci}.{s}.{ht}")
                sj = mac(g, e, n_pd * page, (qdd, kdd), f"dS{ci}.{s}.{ht}")
                dcols = n_pd * page
                dcyc = hw.vec_softmax_cycles(hh * g, dcols)
                dops = hw.vec_ops_softmax(hh * g, dcols)
                if kv_quant:
                    dcyc += (2 * hh * g * dcols / hw.vec_lanes
                             * hw.vec_ew_cost)
                    dops += 2 * hh * g * dcols
                pj = emit(unit="VEC", cycles=dcyc, deps=(sj,),
                          tag=f"dP{ci}.{s}.{ht}", vec_ops=dops,
                          l1_bytes=2 * hh * g * dcols * bpe)
                vdd = dma_pages(n_pd, deps=dec_barrier,
                                tag=f"dV{ci}.{s}.{ht}")
                aj = mac(g, n_pd * page, e, (pj, vdd), f"dA{ci}.{s}.{ht}")
                step_sinks.append(
                    emit(unit="DMA", cycles=dq_b / dma_bpc, deps=(aj,),
                         tag=f"dO{ci}.{s}.{ht}", dram_write_bytes=dq_b,
                         l1_bytes=dq_b))
        prev_step = tuple(step_sinks)
    return tasks


def build_shared_prefix(w, t, hw) -> list[Task] | None:
    """Task graph for an admission wave with shared-prefix reuse (§10).

    ``t.cache_frac`` reserves ``round(frac * pool_pages)`` pages for the
    prefix index. The prefix is RESIDENT when the reserve covers its
    full pages; hit admissions then resume chunked prefill at the first
    non-resident token, so resident pages are charged gather-only page
    DMA when read as attention context and are never recomputed or
    written back (their MACs, softmax rows, Q traffic and K/V page
    writes all disappear). Misses — and every request when the prefix
    is not resident — pay the full admission.

    The live pool is what the reserve leaves. Hit requests park their
    prefix in the reserve, so concurrency = live pages over the wave's
    mean per-request footprint, and the decode tail runs in
    ``ceil(n_requests / concurrency)`` serial rounds: each round is a
    chain of step barriers (the engine's single jitted dispatch) whose
    (group x slots) MXU rows pad to the mesh edge, so narrower rounds
    waste both array rows and barrier latency. The search therefore
    prices reserve-for-reuse against concurrency-for-throughput; 0.0
    (sharing off) stays in the space so it decides whether a reserve
    pays at this hit rate.
    """
    page = min(t.nkv, w.prompt)
    bpe = hw.bytes_per_elem
    kv_bpe = _effective_kv_bpe(w, t, hw)
    kv_quant = kv_bpe < bpe
    heads_core = -(-w.heads // hw.cores)
    hh = min(t.hh, heads_core)
    n_head_tiles = -(-heads_core // hh)
    g, e = w.group, w.emb

    frac = t.cache_frac or 0.0
    if not 0.0 <= frac < 1.0:
        return None
    reserve = round(frac * w.pool_pages)
    prefix_pages = w.prefix // page      # only FULL pages are reusable
    hit_tokens = prefix_pages * page
    resident = 0 < prefix_pages <= reserve
    eff_hit = w.hit_rate if resident else 0.0
    n_hits = round(eff_hit * w.n_requests)
    per_req = -(-(w.prompt + w.new_tokens) // page)
    hit_req = per_req - (prefix_pages if resident else 0)
    mean_req = (n_hits * hit_req
                + (w.n_requests - n_hits) * per_req) / w.n_requests
    live = w.pool_pages - reserve
    concurrency = min(w.n_requests, int(live / mean_req))
    if concurrency < 1:
        return None  # the reserve ate the live pool

    # Admission step size: the searched t.chunk when set (page-aligned,
    # §5.6-feasible, like build_chunked_prefill), else the largest
    # page-aligned chunk <= ~256 tokens that fits the L1 row buffer.
    visible = -(-w.prompt // page) * page

    def fits(c: int) -> bool:
        rows = hh * g * c
        need = (2 * rows * visible * bpe + hh * 4 * page * e * kv_bpe
                + 2 * rows * e * bpe)
        return need <= hw.l1_bytes

    if t.chunk is not None:
        chunk = min(t.chunk, w.prompt)
        if (chunk % page and chunk != w.prompt) or not fits(chunk):
            return None
    else:
        chunk = 0
        c = min(w.prompt, page * max(1, 256 // page))
        while c >= page:
            if fits(c):
                chunk = c
                break
            c -= page
        if not chunk:
            return None

    dma_bpc = hw.dram_bytes_per_cycle / hw.cores
    tasks: list[Task] = []

    def emit(**kw) -> int:
        tasks.append(Task(**kw))
        return len(tasks) - 1

    page_b = hh * page * e * kv_bpe + (hh * 4 if kv_quant else 0)

    def dma_pages(n, deps=(), tag="", write=False) -> int:
        nbytes = n * page_b
        kw = {"dram_write_bytes" if write else "dram_read_bytes": nbytes}
        return emit(unit="DMA",
                    cycles=n * hw.dma_page_setup_cycles + nbytes / dma_bpc,
                    deps=tuple(deps), tag=tag, l1_bytes=nbytes, **kw)

    def mac(m, k, n, deps, tag) -> int:
        return emit(unit="MAC", cycles=hh * hw.mac_cycles(m, k, n),
                    deps=tuple(deps), tag=tag, mac_ops=hh * m * k * n,
                    l1_bytes=(m * k + k * n + m * n) * hh * bpe)

    # -- admission wave: hits resume at the first non-resident token --
    prev: tuple[int, ...] = ()
    for r in range(w.n_requests):
        q0 = hit_tokens if r < n_hits else 0
        while q0 < w.prompt:
            clen = min(chunk, w.prompt - q0)
            kv_len = q0 + clen
            n_ctx = -(-kv_len // page)        # resident pages gather here
            n_full = min((q0 + 1) // page, n_ctx)
            rows_t = g * clen
            rows = hh * rows_t
            q_b = rows * e * bpe
            sinks: list[int] = []
            for ht in range(n_head_tiles):
                qd = emit(unit="DMA", cycles=q_b / dma_bpc, deps=prev,
                          tag=f"Q{r}.{q0}.{ht}", dram_read_bytes=q_b,
                          l1_bytes=q_b)
                kd = dma_pages(n_ctx, deps=prev, tag=f"K{r}.{q0}.{ht}")
                cj = mac(rows_t, e, n_ctx * page, (qd, kd),
                         f"C{r}.{q0}.{ht}")
                cols = n_ctx * page
                cyc = hw.vec_softmax_cycles(rows, cols)
                ops = hw.vec_ops_softmax(rows, cols)
                mask_elems = (n_ctx - n_full) * rows_t * page
                cyc += mask_elems / hw.vec_lanes * hw.vec_ew_cost
                ops += mask_elems
                if kv_quant:
                    cyc += 2 * rows * cols / hw.vec_lanes * hw.vec_ew_cost
                    ops += 2 * rows * cols
                p = emit(unit="VEC", cycles=cyc, deps=(cj,),
                         tag=f"P{r}.{q0}.{ht}", vec_ops=ops,
                         l1_bytes=2 * rows * cols * bpe)
                vd = dma_pages(n_ctx, deps=prev, tag=f"V{r}.{q0}.{ht}")
                oj = mac(rows_t, n_ctx * page, e, (p, vd),
                         f"O{r}.{q0}.{ht}")
                oo = emit(unit="DMA", cycles=q_b / dma_bpc, deps=(oj,),
                          tag=f"Oout{r}.{q0}.{ht}", dram_write_bytes=q_b,
                          l1_bytes=q_b)
                # only the chunk's OWN pages are written — a hit never
                # rewrites the resident prefix pages it resumed past
                n_cp = -(-clen // page)
                wdeps: tuple[int, ...] = prev
                if kv_quant:
                    elems = 2 * hh * clen * e
                    wdeps = (emit(unit="VEC", tag=f"quant{r}.{q0}.{ht}",
                                  deps=prev,
                                  cycles=2 * elems / hw.vec_lanes
                                  * hw.vec_ew_cost,
                                  vec_ops=2 * elems,
                                  l1_bytes=2 * elems * bpe),)
                sinks += [oo] + [
                    dma_pages(n_cp, deps=wdeps, tag=f"{which}w{r}.{q0}.{ht}",
                              write=True) for which in ("K", "V")
                ]
            prev = tuple(sinks)
            q0 += clen

    # -- decode tail in serial rounds of ``concurrency`` slots --
    kv_d = w.prompt + w.new_tokens
    n_pd = -(-kv_d // page)
    done = 0
    while done < w.n_requests:
        slots = min(concurrency, w.n_requests - done)
        done += slots
        dq_b = hh * g * slots * e * bpe
        for st in range(w.new_tokens):
            sinks = []
            for ht in range(n_head_tiles):
                qd = emit(unit="DMA", cycles=dq_b / dma_bpc, deps=prev,
                          tag=f"dQ{done}.{st}.{ht}", dram_read_bytes=dq_b,
                          l1_bytes=dq_b)
                kd = dma_pages(slots * n_pd, deps=prev,
                               tag=f"dK{done}.{st}.{ht}")
                sj = mac(g * slots, e, n_pd * page, (qd, kd),
                         f"dS{done}.{st}.{ht}")
                dcols = n_pd * page
                drows = hh * g * slots
                dcyc = hw.vec_softmax_cycles(drows, dcols)
                dops = hw.vec_ops_softmax(drows, dcols)
                if kv_quant:
                    dcyc += (2 * drows * dcols / hw.vec_lanes
                             * hw.vec_ew_cost)
                    dops += 2 * drows * dcols
                pj = emit(unit="VEC", cycles=dcyc, deps=(sj,),
                          tag=f"dP{done}.{st}.{ht}", vec_ops=dops,
                          l1_bytes=2 * drows * dcols * bpe)
                vd = dma_pages(slots * n_pd, deps=prev,
                               tag=f"dV{done}.{st}.{ht}")
                aj = mac(g * slots, n_pd * page, e, (pj, vd),
                         f"dA{done}.{st}.{ht}")
                sinks.append(
                    emit(unit="DMA", cycles=dq_b / dma_bpc, deps=(aj,),
                         tag=f"dO{done}.{st}.{ht}", dram_write_bytes=dq_b,
                         l1_bytes=dq_b))
            prev = tuple(sinks)
    return tasks


_BUILDERS = {
    "mas": build_mas,
    "flat": build_flat,
    "layerwise": build_layerwise,
    "softpipe": build_softpipe,
    "tileflow": build_tileflow,
    "fusemax": build_fusemax,
    "paged_decode": build_paged_decode,
    "chunked_prefill": build_chunked_prefill,
    "speculative_decode": build_speculative_decode,
    "shared_prefix": build_shared_prefix,
    "sharded_serving": build_sharded_serving,
}


def build_schedule(method: str, w: AttentionWorkload, t: Tiling,
                   hw: HWConfig) -> list[Task] | None:
    return _BUILDERS[method](w, t, hw)


def tiling_space(w: AttentionWorkload, hw: HWConfig) -> list[Tiling]:
    """The search space of multi-tiered tiling factors (§4.2).

    For paged decode workloads the N_Q tier collapses (the MXU row dim
    is the fixed GQA group) and N_KV becomes the page size, extended
    down to 16 rows: decode is DMA-bound, so the optimum balances
    partial-page boundary waste against per-page descriptor overhead
    and sits well below the prefill sub-tile sizes. The KV element
    width joins the decode space as a fourth factor (native vs int8):
    precision is searched exactly like page size (DESIGN.md §5).

    Chunked-prefill workloads add the CHUNK SIZE as a fifth factor
    (DESIGN.md §6): the prompt-tokens-per-step budget of the mixed
    scheduler, searched jointly with page size and precision, with
    ``None`` (monolithic whole-prompt admission) in the space so the
    search itself decides whether chunking pays.

    Speculative-decode workloads add the SPECULATION DEPTH as a sixth
    factor (DESIGN.md §9): candidate rows per verify step, searched
    jointly with page size and precision, with k=1 (plain decode) in
    the space so the search decides whether speculation pays.

    Shared-prefix workloads add the CACHE-RESERVE FRACTION as a seventh
    factor (DESIGN.md §10): the pool slice parked under the prefix
    index, searched jointly with page size and precision, with 0.0
    (sharing off) in the space so the search decides whether a reserve
    pays at the workload's hit rate.

    Sharded-serving workloads add the SHARD DEGREE as an eighth factor
    (DESIGN.md §11): mesh chips the KV heads split across, searched
    jointly with page size and precision over the degrees that divide
    the head count, with 1 (single chip) in the space so the search
    decides whether the interconnect can pay for a mesh at all.
    """
    heads_core = -(-w.heads // hw.cores)
    hhs = sorted({h for h in (1, 2, 4, 8, 16) if h <= heads_core}
                 | {heads_core})
    if isinstance(w, ChunkedPrefillWorkload):
        # Admission schedule: the CHUNK SIZE joins page size, kv-head
        # tile and precision as the searched factors. ``None`` chunk =
        # monolithic whole-prompt admission, ranked against the finite
        # chunks (for long prompts it overflows the §5.6 row buffer and
        # drops out of the feasible set).
        pages = sorted({p for p in (16, 32, 64, 128) if p <= w.prompt}
                       | ({w.prompt} if w.prompt <= 128 else set()))
        chunks: list[int | None] = [None] + sorted(
            {c for c in (64, 128, 256, 512, 1024) if c < w.prompt})
        bpes = sorted({hw.bytes_per_elem, 1})
        return [Tiling(hh, 1, p, bpe, c)
                for hh in hhs for p in pages for bpe in bpes
                for c in chunks]
    if isinstance(w, SharedPrefixWorkload):
        # Reserve schedule: the CACHE-RESERVE FRACTION joins page size,
        # kv-head tile and precision as the searched factors. 0.0
        # (sharing off) stays in the space; fractions above it trade
        # resident-prefix reuse against live-pool concurrency, so the
        # optimum moves with the workload's hit rate.
        pages = sorted({p for p in (16, 32, 64, 128) if p <= w.prompt}
                       | ({w.prompt} if w.prompt <= 128 else set()))
        bpes = sorted({hw.bytes_per_elem, 1})
        fracs = (0.0, 0.125, 0.25, 0.375, 0.5, 0.75)
        return [Tiling(hh, 1, p, bpe, None, None, f)
                for hh in hhs for p in pages for bpe in bpes
                for f in fracs]
    if isinstance(w, SpeculativeDecodeWorkload):
        # Verify schedule: the SPECULATION DEPTH joins page size, kv-head
        # tile and precision as the sixth factor (DESIGN.md §9). k=1 is
        # plain decode and stays in the space, so the search itself
        # decides whether speculation pays for this acceptance rate.
        pages = sorted({p for p in (16, 32, 64, 128, 256, 512)
                        if p <= w.seq} | {w.seq})
        bpes = sorted({hw.bytes_per_elem, 1})
        specs = sorted({k for k in (1, 2, 3, 4, 6, 8) if k <= w.seq})
        return [Tiling(hh, 1, p, bpe, None, k)
                for hh in hhs for p in pages for bpe in bpes
                for k in specs]
    if isinstance(w, ShardedServingWorkload):
        # Mesh schedule: the SHARD DEGREE joins page size, kv-head tile
        # and precision as the eighth factor (DESIGN.md §11). Only
        # degrees dividing the KV-head count are feasible (the pool's
        # Hkv axis is the shard dim); 1 (single chip) stays in the
        # space, so the search itself decides whether the link pays.
        pages = sorted({p for p in (16, 32, 64, 128, 256, 512)
                        if p <= w.seq} | {w.seq})
        bpes = sorted({hw.bytes_per_elem, 1})
        shards = sorted({s for s in (1, 2, 4, 8) if w.heads % s == 0})
        return [Tiling(hh, 1, p, bpe, None, None, None, s)
                for hh in hhs for p in pages for bpe in bpes
                for s in shards]
    if isinstance(w, PagedDecodeWorkload):
        pages = sorted({p for p in (16, 32, 64, 128, 256, 512)
                        if p <= w.seq} | {w.seq})
        bpes = sorted({hw.bytes_per_elem, 1})
        return [Tiling(hh, 1, p, bpe)
                for hh in hhs for p in pages for bpe in bpes]
    nqs = sorted({n for n in (16, 32, 64, 128, 256) if n <= w.seq} | {w.seq})
    nkvs = sorted({n for n in (64, 128, 256, 512) if n <= w.seq} | {w.seq})
    return [Tiling(hh, nq, nkv) for hh in hhs for nq in nqs for nkv in nkvs]
