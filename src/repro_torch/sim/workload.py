"""Attention workloads — Table 1 of the paper, plus helpers."""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AttentionWorkload:
    name: str
    heads: int
    seq: int
    emb: int  # per-head embedding (Emb_{K,V} column of Table 1)
    batch: int = 1
    # Causal prefill: the score grid is lower-triangular and schedule
    # builders only emit tiles that intersect the diagonal or sit below it
    # (DESIGN.md §3). Table 1 workloads are bidirectional (False).
    causal: bool = False
    # KV operand width in bytes (DESIGN.md §5). None -> the device's
    # native bytes_per_elem; 1 -> int8 KV with fp32 per-row scale
    # side-traffic and a VEC dequant pass charged by the schedules
    # (resolved through schedules._effective_kv_bpe).
    kv_bpe: int | None = None

    @property
    def _score_elems(self) -> int:
        """Useful score-matrix elements per (batch, head)."""
        if self.causal:
            return self.seq * (self.seq + 1) // 2
        return self.seq * self.seq

    @property
    def mac_ops(self) -> int:
        """Useful MACs: QK^T + PV (lower bound — tile padding adds more)."""
        return 2 * self.batch * self.heads * self._score_elems * self.emb

    @property
    def softmax_elems(self) -> int:
        return self.batch * self.heads * self._score_elems

    def qkv_bytes(self, bpe: int) -> int:
        return 3 * self.batch * self.heads * self.seq * self.emb * bpe

    def o_bytes(self, bpe: int) -> int:
        return self.batch * self.heads * self.seq * self.emb * bpe

    def score_bytes(self, bpe: int) -> int:
        """One full C or P matrix (live entries only when causal)."""
        return self.batch * self.heads * self._score_elems * bpe


@dataclasses.dataclass(frozen=True)
class PagedDecodeWorkload:
    """One continuous-batching decode step over a paged KV cache.

    Each sequence contributes a (group x kv_len) score row per kv head;
    the KV cache is fetched page by page, and a partially filled last
    page still moves a whole page of DMA bytes — page size is the
    tiling factor the §4.2 search has to balance against per-page
    descriptor overhead (hw.dma_page_setup_cycles).

    ``heads`` counts KV heads; ``group`` is the GQA group (query heads
    per kv head — the MXU row dimension, like the decode kernel).
    """

    name: str
    heads: int
    emb: int
    kv_lens: tuple[int, ...]      # per-sequence live cache lengths
    group: int = 1
    # KV-cache element width. None -> device native; 1 -> int8 pages
    # with one fp32 scale per page (K and V each) riding the page DMA.
    kv_bpe: int | None = None

    @property
    def batch(self) -> int:
        return len(self.kv_lens)

    @property
    def seq(self) -> int:
        """Longest live sequence — anchors the tiling search space."""
        return max(self.kv_lens)

    @property
    def total_kv(self) -> int:
        return sum(self.kv_lens)

    @property
    def mac_ops(self) -> int:
        """Useful MACs: QK^T + PV over live cache entries only."""
        return 2 * self.heads * self.group * self.total_kv * self.emb

    @property
    def softmax_elems(self) -> int:
        return self.heads * self.group * self.total_kv

    def kv_bytes(self, bpe: int, page: int) -> int:
        """Page-granular K+V DMA: partial pages are charged whole.

        ``bpe`` is the device-native width; a quantized workload
        (``kv_bpe``) overrides it and adds the per-page fp32 scales
        side-traffic (one scalar per page for K and V each).
        """
        pages = sum(-(-n // page) for n in self.kv_lens)
        eff = self.kv_bpe or bpe
        nbytes = 2 * self.heads * pages * page * self.emb * eff
        if self.kv_bpe is not None and self.kv_bpe < bpe:
            nbytes += 2 * self.heads * pages * 4  # fp32 page scales
        return nbytes


@dataclasses.dataclass(frozen=True)
class SpeculativeDecodeWorkload:
    """Speculative decode over a paged KV cache (DESIGN.md §9).

    Models emitting ``new_tokens`` tokens per live sequence via verify
    steps of ``spec`` candidate rows each. Per step the MXU tiles grow
    to (group * spec) rows and the VEC softmax covers ``spec`` score
    rows per kv head, but the page-granular KV DMA is charged ONCE —
    exactly the verify kernel's economics: the gather walks the pool
    once regardless of how many candidate rows ride along. Acceptance
    follows the engine's greedy longest-prefix(+bonus) rule under an
    i.i.d. per-draft acceptance probability ``accept_rate``, so a step
    lands E(k) = (1 - p^k) / (1 - p) tokens in expectation and the
    schedule needs ceil(new_tokens / E(k)) serial steps. Minimizing
    plain simulated cycles therefore already trades step count against
    per-step width — the SIXTH searchable tiling factor
    (``Tiling.spec``) has a real, hardware-dependent optimum instead of
    degenerating to k=1.

    Drafting itself is host-side string matching (``serving.drafter``)
    and is not charged. ``spec`` here is the workload's PIN (None ->
    the search supplies it via ``Tiling.spec``); ``heads`` counts KV
    heads and ``group`` is the GQA group, as in ``PagedDecodeWorkload``.
    """

    name: str
    heads: int
    emb: int
    kv_lens: tuple[int, ...]      # per-sequence live cache lengths
    group: int = 1
    kv_bpe: int | None = None
    new_tokens: int = 16          # tokens to emit per sequence
    accept_rate: float = 0.7      # per-draft i.i.d. acceptance prob
    spec: int | None = None       # pinned depth; None -> Tiling.spec

    @property
    def batch(self) -> int:
        return len(self.kv_lens)

    @property
    def seq(self) -> int:
        """Longest live sequence — anchors the tiling search space."""
        return max(self.kv_lens)

    @property
    def total_kv(self) -> int:
        return sum(self.kv_lens)

    def expected_tokens_per_step(self, spec: int) -> float:
        """Accepted tokens per verify step at depth ``spec`` under the
        greedy longest-prefix + bonus rule: E = sum_{i<k} p^i."""
        p = self.accept_rate
        if spec <= 1 or p <= 0.0:
            return 1.0
        if p >= 1.0:
            return float(spec)
        return (1.0 - p ** spec) / (1.0 - p)

    def n_steps(self, spec: int) -> int:
        """Serial verify steps to land ``new_tokens`` per sequence."""
        return max(1, math.ceil(
            self.new_tokens / self.expected_tokens_per_step(spec)))

    @property
    def mac_ops(self) -> int:
        """Useful MACs for the whole generation at the PINNED depth
        (spec=1 when unpinned): QK^T + PV over live cache entries, one
        verify step's rows times the step count."""
        k = self.spec or 1
        per_step = 2 * self.heads * self.group * k * self.total_kv * self.emb
        return per_step * self.n_steps(k)

    @property
    def softmax_elems(self) -> int:
        k = self.spec or 1
        return self.heads * self.group * k * self.total_kv * self.n_steps(k)

    def kv_bytes(self, bpe: int, page: int) -> int:
        """Page-granular K+V DMA for ONE verify step — charged once per
        step regardless of depth (the whole point of verifying k rows
        in a single dispatch). Same accounting as ``PagedDecodeWorkload``."""
        pages = sum(-(-n // page) for n in self.kv_lens)
        eff = self.kv_bpe or bpe
        nbytes = 2 * self.heads * pages * page * self.emb * eff
        if self.kv_bpe is not None and self.kv_bpe < bpe:
            nbytes += 2 * self.heads * pages * 4  # fp32 page scales
        return nbytes


@dataclasses.dataclass(frozen=True)
class ChunkedPrefillWorkload:
    """Admission of one long prompt into a paged pool, co-scheduled with
    live decode slots (DESIGN.md §6).

    Models the continuous-batching engine's token-budgeted step: per
    chunk of ``chunk`` prompt tokens (the searchable ``Tiling.chunk``
    factor), the schedule charges page-granular KV-read DMA for ALL
    prior context plus the chunk itself, the causal three-band masking
    on the VEC stream, the paged WRITE traffic for the chunk's own K/V
    pages (plus a quantize pass for int8 pools), and then one decode
    step over ``decode_kv_lens`` — the live slots that advance while
    the prompt is mid-admission.

    ``heads`` counts KV heads; ``group`` is the GQA group (query heads
    per kv head), so prompt Q rows per kv head are ``group * chunk``.
    """

    name: str
    heads: int
    emb: int
    prompt: int                        # prompt length in tokens
    group: int = 1
    decode_kv_lens: tuple[int, ...] = ()  # live decode slots' cache lens
    # KV-cache element width. None -> device native; 1 -> int8 pages
    # with one fp32 scale per page (K and V each) riding the page DMA.
    kv_bpe: int | None = None
    # Preemption churn (DESIGN.md §7): expected recompute passes per
    # admitted prompt when the pool runs hot (decode_reserve_frac < 1).
    # Each preemption replays the whole admission — the schedule charges
    # ceil(rate * n_chunks) extra chunk steps (prior-context re-read,
    # page re-write, interleaved decode) so the search prices the cost
    # of a pool sized below full reservation.
    preempt_rate: float = 0.0

    @property
    def seq(self) -> int:
        """Anchors the tiling search space (page and chunk caps)."""
        return self.prompt

    @property
    def _score_elems(self) -> int:
        """Causal triangle of the prompt (useful lower bound)."""
        return self.prompt * (self.prompt + 1) // 2

    @property
    def mac_ops(self) -> int:
        """Useful MACs: prefill QK^T + PV over the causal triangle plus
        the interleaved decode steps over live cache entries; recompute
        churn replays the prefill triangle ``preempt_rate`` more times
        (a lower bound — the scheduled replay is chunk-granular)."""
        prefill = 2 * self.heads * self.group * self._score_elems * self.emb
        prefill += int(self.preempt_rate * prefill)
        decode = 2 * self.heads * self.group * sum(self.decode_kv_lens) \
            * self.emb
        return prefill + decode

    @property
    def softmax_elems(self) -> int:
        tri = self._score_elems
        return self.heads * self.group * (
            tri + int(self.preempt_rate * tri) + sum(self.decode_kv_lens)
        )

    def n_chunks(self, chunk: int | None) -> int:
        """Engine steps this admission takes at ``chunk`` prompt tokens
        per step (``None`` = monolithic whole-prompt admission)."""
        if chunk is None:
            return 1
        return -(-self.prompt // chunk)


@dataclasses.dataclass(frozen=True)
class SharedPrefixWorkload:
    """An admission wave over a pool with shared-prefix reuse (§10).

    ``n_requests`` prompts of ``prompt`` tokens arrive, a ``hit_rate``
    fraction of them opening with the same ``prefix`` tokens (the
    common system prompt). The pool holds ``pool_pages`` pages and
    ``Tiling.cache_frac`` reserves a slice of it for the prefix index.
    When the reserve covers the prefix's FULL pages the prefix is
    resident: hit admissions resume chunked prefill at the first
    non-resident token — the resident pages are only GATHERED (page
    DMA) as attention context, never recomputed or rewritten — and
    their shared pages stop counting against the live pool. The cost:
    every reserved page shrinks live-decode concurrency, so the decode
    tail runs in more serial rounds of narrower (MXU-padded) steps.
    That reserve-for-reuse vs concurrency-for-throughput trade is what
    the SEVENTH search factor prices (DESIGN.md §10).
    """

    name: str
    heads: int
    emb: int
    prompt: int                   # tokens per request (prefix + suffix)
    prefix: int                   # shared leading tokens
    pool_pages: int               # host pool size (scratch excluded)
    n_requests: int = 4
    hit_rate: float = 0.5         # fraction arriving with the prefix
    new_tokens: int = 8           # decode tokens per request
    group: int = 1
    kv_bpe: int | None = None

    def __post_init__(self):
        if not 0 <= self.prefix <= self.prompt:
            raise ValueError("prefix must lie within the prompt")
        if not 0.0 <= self.hit_rate <= 1.0:
            raise ValueError("hit_rate must be a probability")

    @property
    def batch(self) -> int:
        return self.n_requests

    @property
    def seq(self) -> int:
        """Anchors the tiling search space (page cap)."""
        return self.prompt

    @property
    def _prefill_elems(self) -> int:
        """Useful score elements across the wave assuming FULL prefix
        reuse for hits (lower bound — page granularity rounds the
        actual reuse down to whole pages)."""
        tri = self.prompt * (self.prompt + 1) // 2
        hit_tri = tri - self.prefix * (self.prefix + 1) // 2
        n_hits = round(self.hit_rate * self.n_requests)
        return n_hits * hit_tri + (self.n_requests - n_hits) * tri

    @property
    def _decode_elems(self) -> int:
        return self.n_requests * self.new_tokens * (
            self.prompt + self.new_tokens)

    @property
    def mac_ops(self) -> int:
        """Useful MACs: QK^T + PV over the wave's prefills (hits skip
        their resident prefix rows) plus the decode tail."""
        return 2 * self.heads * self.group * self.emb * (
            self._prefill_elems + self._decode_elems)

    @property
    def softmax_elems(self) -> int:
        return self.heads * self.group * (
            self._prefill_elems + self._decode_elems)


@dataclasses.dataclass(frozen=True)
class ShardedServingWorkload:
    """A serial run of decode steps on a KV-head-sharded mesh (§11).

    ``shard`` chips each own ``heads / shard`` KV heads of the paged
    pool, so one decode step's MAC / VEC / page-DMA work divides by the
    shard degree — but every step ends with a ring all-gather of the
    per-head attention outputs (``shard - 1`` serial hops on the LINK
    stream, each paying ``hw.link_setup_cycles`` plus its payload over
    ``hw.link_gbps``) before the replicated output projection can run.
    ``n_steps`` decode steps run back-to-back (each step's gather gates
    the next step's compute, exactly the engine's serial greedy loop),
    so minimizing simulated cycles trades per-chip compute shrink
    against per-step collective growth: the EIGHTH searchable tiling
    factor (``Tiling.shard``) has an interior optimum that moves with
    the link bandwidth — near-zero bandwidth collapses to one chip,
    fat links buy more.

    ``heads`` counts KV heads (the shard dimension of the
    ``(Hkv, P, page, E)`` pool layout); ``group`` is the GQA group;
    ``shard`` here is the workload's PIN (None -> the search supplies
    it via ``Tiling.shard``). ``out_bpe`` is the element width of the
    gathered attention outputs (the model compute dtype — gathering
    moves activations, not KV pages).
    """

    name: str
    heads: int
    emb: int
    kv_lens: tuple[int, ...]      # per-sequence live cache lengths
    group: int = 1
    kv_bpe: int | None = None
    n_steps: int = 16             # serial decode steps priced
    shard: int | None = None      # pinned degree; None -> Tiling.shard
    out_bpe: int = 2              # gathered head-output element width

    @property
    def batch(self) -> int:
        return len(self.kv_lens)

    @property
    def seq(self) -> int:
        """Longest live sequence — anchors the tiling search space."""
        return max(self.kv_lens)

    @property
    def total_kv(self) -> int:
        return sum(self.kv_lens)

    @property
    def mac_ops(self) -> int:
        """Useful MACs across the whole run (all chips, all steps)."""
        return 2 * self.heads * self.group * self.total_kv * self.emb \
            * self.n_steps

    @property
    def softmax_elems(self) -> int:
        return self.heads * self.group * self.total_kv * self.n_steps

    def kv_bytes(self, bpe: int, page: int) -> int:
        """Page-granular K+V DMA for ONE step across ALL chips — the
        per-chip schedule divides this by the shard degree. Same
        accounting as ``PagedDecodeWorkload``."""
        pages = sum(-(-n // page) for n in self.kv_lens)
        eff = self.kv_bpe or bpe
        nbytes = 2 * self.heads * pages * page * self.emb * eff
        if self.kv_bpe is not None and self.kv_bpe < bpe:
            nbytes += 2 * self.heads * pages * 4  # fp32 page scales
        return nbytes

    def gather_bytes(self, shard: int) -> int:
        """LINK bytes one chip RECEIVES per step in the ring all-gather
        of head outputs: (shard - 1) hops of one chip's slice each."""
        full = self.batch * self.heads * self.group * self.emb * self.out_bpe
        return (shard - 1) * (full // shard)


def serving_phase_workloads(name: str, prompt_lens, max_new: int, *,
                            heads: int, emb: int, group: int = 1,
                            batch: int = 4, kv_bpe: int | None = None,
                            spec: int | None = None,
                            accept_rate: float = 0.7) -> dict:
    """Sim workloads matching the continuous engine's step kinds, keyed
    by the compare phases of ``repro_torch.obs.compare`` (DESIGN.md §8).

    Built from the MEASURED request set so the simulated schedule prices
    the same scenario the serving trace recorded: ``decode`` is one
    engine step over ``batch`` live slots at mid-decode cache depth
    (prompt + max_new/2); ``prefill_chunk`` is the admission of the
    longest prompt while the remaining slots decode — exactly what a
    ``chunk+decode`` step dispatches. With ``spec`` set, a ``verify``
    phase joins them: the speculative engine's multi-token verify steps
    over the same slots (DESIGN.md §9), at the measured acceptance rate.
    """
    lens = sorted((int(p) for p in prompt_lens), reverse=True)
    if not lens:
        raise ValueError("serving_phase_workloads needs >= 1 prompt")
    kv_lens = tuple(p + max_new // 2 for p in lens[:batch])
    phases = {
        "decode": PagedDecodeWorkload(
            f"{name}-decode", heads=heads, emb=emb, group=group,
            kv_lens=kv_lens, kv_bpe=kv_bpe),
        "prefill_chunk": ChunkedPrefillWorkload(
            f"{name}-admit", heads=heads, emb=emb, group=group,
            prompt=lens[0], decode_kv_lens=kv_lens[1:], kv_bpe=kv_bpe),
    }
    if spec is not None:
        phases["verify"] = SpeculativeDecodeWorkload(
            f"{name}-verify", heads=heads, emb=emb, group=group,
            kv_lens=kv_lens, kv_bpe=kv_bpe, new_tokens=max_new,
            accept_rate=accept_rate, spec=spec)
    return phases


# Table 1: Network Configuration and Hyper-Parameters.
PAPER_NETWORKS = {
    "bert-base-t5-base": AttentionWorkload("bert-base-t5-base", 12, 512, 64),
    "bert-large-t5-large": AttentionWorkload("bert-large-t5-large", 16, 512, 64),
    "bert-small": AttentionWorkload("bert-small", 8, 512, 64),
    "llama3-8b-t5-3b": AttentionWorkload("llama3-8b-t5-3b", 32, 512, 128),
    "t5-mini-small": AttentionWorkload("t5-mini-small", 8, 512, 32),
    "vit-b-14": AttentionWorkload("vit-b-14", 12, 196, 64),
    "vit-l-14": AttentionWorkload("vit-l-14", 16, 196, 64),
    "vit-h-14": AttentionWorkload("vit-h-14", 16, 196, 80),
    "vit-b-16": AttentionWorkload("vit-b-16", 12, 256, 64),
    "vit-l-16": AttentionWorkload("vit-l-16", 16, 256, 64),
    "vit-h-16": AttentionWorkload("vit-h-16", 16, 256, 80),
    "xlm": AttentionWorkload("xlm", 8, 512, 128),
}

# Paper-reported cycle counts (10^6) for validation (Table 2).
PAPER_TABLE2_CYCLES = {
    #                      layerwise softpipe  flat  tileflow fusemax  mas
    "bert-base-t5-base":    (3.637, 2.064, 1.573, 0.799, 0.992, 0.786),
    "bert-large-t5-large":  (5.505, 2.753, 1.835, 1.311, 1.323, 1.049),
    "bert-small":           (2.753, 1.376, 0.918, 0.655, 0.661, 0.524),
    "llama3-8b-t5-3b":      (12.845, 8.389, 4.719, 5.243, 4.864, 4.194),
    "t5-mini-small":        (2.228, 1.180, 0.721, 0.328, 0.384, 0.262),
    "vit-b-14":             (0.612, 0.381, 0.266, 0.263, 0.196, 0.151),
    "vit-l-14":             (1.242, 0.508, 0.354, 0.351, 0.262, 0.201),
    "vit-h-14":             (1.355, 0.558, 0.405, 0.439, 0.318, 0.251),
    "vit-b-16":             (1.081, 0.590, 0.426, 0.249, 0.259, 0.197),
    "vit-l-16":             (1.311, 0.786, 0.524, 0.332, 0.346, 0.262),
    "vit-h-16":             (1.376, 0.852, 0.590, 0.414, 0.419, 0.328),
    "xlm":                  (4.194, 2.097, 1.180, 1.311, 1.216, 1.049),
}

PAPER_TABLE2_ORDER = (
    "layerwise", "softpipe", "flat", "tileflow", "fusemax", "mas"
)
