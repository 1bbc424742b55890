"""Serving engines: dense batched waves and paged continuous batching.

Port of ``ServingEngine`` and ``ContinuousBatchingEngine`` from
``repro/serving/engine.py`` (the latter without prefix sharing). Both
take ``kv_dtype="int8"``: the wave engine then keeps a dense int8 cache
with per-row scales, the continuous engine int8 page pools with per-page
scales.

``ServingEngine`` groups requests into buckets of equal prompt length,
pads a wave of up to ``batch_size`` requests with dummy rows to a fixed
batch, allocates a dense (batch, max_len) cache per wave (for an SSM
stack, the per-layer conv and SSD states instead), prefills once, then
decodes greedily until every real request of the wave has stopped.

``ContinuousBatchingEngine`` serves dense decoder stacks only (it
refuses an SSM stack, as the reference's paged cache does). It serves
one long-lived decode batch over the global page pools of
``serving/paged_cache.py``: finished sequences free
their pages between steps, and each engine step packs up to
``chunk_size`` prompt tokens of the head-of-queue request with all live
decode slots, so decode advances while a long prompt is admitted. Pool
exhaustion mid-decode preempts the youngest live request, which re-queues
and later re-prefills its prompt and generated tokens. With
``spec_depth`` set, pure-decode steps become speculative: a prompt-lookup
drafter proposes candidates, one verify step scores them all, and each
slot keeps its longest greedy-matching prefix plus one token.

Each step of either engine moves ONE packed int32 tensor from the device
to the host: the next tokens packed with the finite-logit guard's flags.
A continuous-batching step also moves ONE from the host to the device:
the step's tokens, positions and page tables.

Every request runs through the lifecycle state machine of
``serving/lifecycle.py``: a malformed request becomes a FAILED result
instead of an exception, deadlines and ``cancel`` end a request at step
granularity, and a row whose logits are not finite fails alone while the
rest of the batch decodes on. ``engine.metrics`` (fresh per ``serve()``)
holds the per-token wall-clock stamps, pool occupancy, step-time
histograms and preemption counters; an enabled ``Tracer`` records
per-request lifecycle spans and per-step spans.
"""

from __future__ import annotations

import itertools
import time
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.autotune import (
    tune_pool_headroom,
    tune_prefill_chunk,
    tune_spec_depth,
)
from repro_torch.models.api import Model
from repro_torch.models.transformer import (
    check_paged_support,
    kv_storage_dtype,
)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.drafter import NgramDrafter
from repro_torch.serving.faults import NO_FAULTS
from repro_torch.serving.lifecycle import (
    Request,
    RequestRecord,
    RequestState,
    TERMINAL_STATES,
    validate_request,
)
from repro_torch.serving.paged_cache import (
    SCRATCH_PAGE,
    PagedKVCacheManager,
    PagePoolExhausted,
    page_footprint_bytes,
)

__all__ = ["Request", "ServingEngine", "ContinuousBatchingEngine"]


def _finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(rows, V) -> (rows,) bool: the NaN/inf guard on a step's logits,
    computed on the device so its flags ride the step's one transfer."""
    return torch.isfinite(logits).all(dim=-1)

# lifecycle states that open a nested phase span on the request's track
_PHASE_STATES = frozenset({
    RequestState.PREFILLING, RequestState.DECODING, RequestState.PREEMPTED,
})


def _trace_request(rec: RequestRecord, tracer) -> None:
    """Open a per-request lifecycle span and drive its nested phase spans
    off the state machine: every ``RequestRecord.to()`` closes the span of
    the state it leaves and opens one for the state it enters."""
    if not tracer.enabled:
        return
    track = f"req{rec.rid}"
    tracer.begin("request", track=track, cat="lifecycle", args={
        "rid": rec.rid,
        "prompt_len": int(len(rec.request.prompt)),
        "max_new_tokens": int(rec.request.max_new_tokens),
    })

    def observe(r: RequestRecord, old: RequestState,
                new: RequestState) -> None:
        if old in _PHASE_STATES:
            tracer.end(old.value, track=track)
        if new in _PHASE_STATES:
            tracer.begin(new.value, track=track, cat="lifecycle")
        elif new in TERMINAL_STATES:
            tracer.end("request", track=track, args={
                "state": new.value,
                "tokens": len(r.tokens),
                "preemptions": r.preemptions,
                "error": r.error,
            })

    rec.observer = observe


class ServingEngine:
    """Batched waves over a dense cache; ``kv_dtype="int8"`` quantizes the
    cache (each prompt row at prefill, each decoded row as it is written)
    and decode reads it through B4's int8 branch."""

    def __init__(self, model: Model, params, *, max_len: int = 512,
                 batch_size: int = 4, kv_dtype=None, tracer=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine serves on {self.device}")
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_len = max_len
        self.batch_size = batch_size
        self.kv_dtype = kv_storage_dtype(kv_dtype)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = MetricsRegistry()
        self.serve_t0 = 0.0
        self.injector = NO_FAULTS
        self.results: dict[int, RequestRecord] = {}
        self._step_idx = 0

    def _prefill(self, tokens):
        return self.model.prefill(self.params, self.cfg, tokens, self.max_len,
                                  kv_dtype=self.kv_dtype)

    def _decode(self, cache, token, pos: int):
        return self.model.decode_step(self.params, self.cfg, token, cache,
                                      pos)

    def _next_token(self, logits, n_real: int):
        """Greedy tokens for the whole batch (dummy rows get token 1) and
        ``packed``: the live rows' tokens followed by their finite-logit
        flags in ONE int32 tensor, so a step pays a single host sync."""
        last = logits[:n_real, -1]
        live = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        finite = _finite_rows(last).to(torch.int32)
        packed = torch.cat([live[:, 0], finite])
        if n_real == self.batch_size:
            return live, packed
        pad = torch.ones((self.batch_size - n_real, 1), dtype=torch.int32,
                         device=live.device)
        return torch.cat([live, pad]), packed

    @property
    def token_walltimes(self) -> dict:
        """rid -> per-token wall-clock timestamps (held by the registry)."""
        return self.metrics.series("token_walltime_s").by_key

    def _record(self, r: Request) -> RequestRecord:
        rec = self.results.get(r.rid)
        if rec is None or rec.request is not r:
            rec = RequestRecord(r)
            self.results[r.rid] = rec
            _trace_request(rec, self.tracer)
        return rec

    def serve(self, requests: list[Request]) -> dict[int, np.ndarray]:
        """Bucket by prompt length, serve each bucket as batched waves.

        Malformed requests (empty prompt, budget past max_len) become
        FAILED results at admission; ``self.results`` carries each
        request's lifecycle record next to the token dict.
        """
        self.metrics = MetricsRegistry()
        self.results = {}
        self._step_idx = 0
        self.serve_t0 = time.perf_counter()
        out: dict[int, np.ndarray] = {}
        buckets: dict[int, list[Request]] = {}
        for r in requests:
            rec = self._record(r)
            err = validate_request(r, max_len=self.max_len)
            if err:
                rec.fail(err)
                out[r.rid] = np.array([], np.int32)
                continue
            buckets.setdefault(len(r.prompt), []).append(r)
        for _, rs in sorted(buckets.items()):
            for i in range(0, len(rs), self.batch_size):
                wave = []
                for r in rs[i:i + self.batch_size]:
                    rec = self.results[r.rid]
                    dl = r.deadline_s
                    if dl is not None and \
                            time.perf_counter() - self.serve_t0 > dl:
                        rec.cancel("deadline expired")
                        out[r.rid] = np.array([], np.int32)
                    else:
                        wave.append(r)
                if wave:
                    out.update(self.serve_wave(wave))
        return out

    def serve_wave(self, requests: list[Request]) -> dict[int, np.ndarray]:
        """Serve up to batch_size same-length requests as one wave."""
        if len(requests) > self.batch_size:
            raise ValueError(
                f"a wave holds at most {self.batch_size} requests")
        plens = {len(r.prompt) for r in requests}
        if len(plens) != 1:
            raise ValueError("serve_wave needs equal prompt lengths")
        plen = plens.pop()
        n_real = len(requests)
        recs = [self._record(r) for r in requests]
        for rec in recs:
            rec.to(RequestState.PREFILLING)
        reqs = list(requests)
        while len(reqs) < self.batch_size:  # pad with a dummy row
            reqs.append(Request(rid=-1, prompt=np.ones((plen,), np.int32),
                                max_new_tokens=0))
        prompts = np.stack([r.prompt for r in reqs]).astype(np.int64)
        with self.tracer.span("prefill_dispatch", track="engine",
                              args={"plen": plen, "n_real": n_real}):
            logits, cache = self._prefill(
                torch.from_numpy(prompts).to(self.device))

        # Dummy rows never decode tokens: real requests alone bound the
        # wave length, and the argmax and the device->host transfer run
        # on the live batch prefix only.
        max_new = max(r.max_new_tokens for r in requests)
        out = {r.rid: [] for r in requests}
        done = np.array([r.max_new_tokens == 0 for r in requests])
        for i, rec in enumerate(recs):
            if done[i]:
                rec.finish()          # zero budget: nothing to generate
            else:
                rec.to(RequestState.DECODING)

        m = self.metrics
        m_walltimes = m.series("token_walltime_s",
                               "per-token wall-clock stamps by rid")
        m_nan = m.counter("serving.nan_guard_trips",
                          "slots failed by the finite-logit guard")
        m_tokens = m.counter("serving.tokens_generated")
        m_step = m.histogram("engine.step_s.wave_decode",
                             "host sync + bookkeeping + decode dispatch")
        m_sync = m.histogram("engine.host_sync_s",
                             "device->host transfer wait per step")
        tr = self.tracer
        token, packed = self._next_token(logits, n_real)
        for step in range(max_new):
            t_step0 = time.perf_counter()
            self.injector.step_begin(self, self._step_idx)
            # One device->host transfer per step, live rows only.
            raw = packed.cpu().numpy()
            t_sync = time.perf_counter()
            m_sync.observe(t_sync - t_step0)
            token_host = raw[:n_real]
            ok_host = np.asarray(
                self.injector.corrupt_step_ok(
                    self._step_idx, raw[n_real:].astype(bool)))
            self._step_idx += 1
            now = time.perf_counter()
            for i, r in enumerate(requests):
                if done[i]:
                    continue
                rec = recs[i]
                if not ok_host[i]:
                    # the NaN/inf guard fails this row; the rest decode on
                    rec.fail("non-finite logits")
                    m_nan.inc()
                    done[i] = True
                    continue
                dl = r.deadline_s
                if dl is not None and now - self.serve_t0 > dl:
                    rec.cancel("deadline expired")
                    done[i] = True
                    continue
                t = int(token_host[i])
                out[r.rid].append(t)
                rec.tokens.append(t)
                m_walltimes.observe(r.rid, now)
                m_tokens.inc()
                if t == r.eos_id or len(out[r.rid]) >= r.max_new_tokens:
                    rec.finish()
                    done[i] = True
            if done.all():
                break
            logits, cache = self._decode(cache, token.to(torch.int64),
                                         plen + step)
            token, packed = self._next_token(logits, n_real)
            t_end = time.perf_counter()
            m_step.observe(t_end - t_step0)
            if tr.enabled:
                tr.complete("step", tr.to_us(t_step0),
                            (t_end - t_step0) * 1e6, track="engine",
                            args={"kind": "wave_decode", "step": step,
                                  "n_real": n_real})
                tr.complete("host_sync", tr.to_us(t_step0),
                            (t_sync - t_step0) * 1e6, track="engine")
        for rec in recs:
            if rec.state not in TERMINAL_STATES:
                rec.finish()
        return {rid: np.array(v, np.int32) for rid, v in out.items()}


class ContinuousBatchingEngine:
    """Paged-KV continuous batching with chunked prefill admission.

    ``batch_size`` decode slots share page pools of ``num_pages`` pages
    (default: full residency for every slot plus the scratch page).
    Admission is reservation-based FIFO: the head-of-queue request takes a
    free slot as soon as pages for its prompt and its decode reservation
    are free. Its prompt is then prefilled ``chunk_size`` tokens per engine
    step, each chunk written straight into its pages by ``prefill_chunk``
    in the same step as the live decode slots; the first token comes from
    the last chunk's logits. Steps are of three kinds: ``decode``,
    ``chunk`` (no live decode slot) and ``chunk+decode``.

    ``decode_reserve_frac`` < 1 runs the pool hot: admission reserves that
    fraction of a request's decode budget, so ``append`` may exhaust the
    pool mid-decode. The scheduler then preempts the youngest live
    request (audited release, requeue at the head, chunked re-prefill of
    prompt and generated tokens). ``headroom_pages`` free pages are held
    back from fresh admissions so preempted requests can re-admit; the
    default is ``core/autotune.tune_pool_headroom`` when the pool is
    overcommitted, 0 otherwise. A request preempted more than
    ``max_preemptions`` times fails.

    ``kv_dtype="int8"`` stores the pools quantized with per-page scales:
    chunk writes quantize whole pages, decode and verify appends
    requantize the pages they touch.

    ``spec_depth`` = k switches pure-decode steps to speculative decoding:
    a prompt-lookup drafter (``spec_ngram``) proposes up to k - 1
    candidates per live slot, one verify dispatch scores every candidate
    position against the pools, and each slot keeps its longest prefix of
    drafts equal to the model's greedy argmax plus one token, so at least
    one token a step and the same tokens as plain greedy decode. The pages
    the candidates land in are reserved before the dispatch
    (``ensure_capacity``, preempting the youngest request if the pool is
    short) and the kept tokens are committed after it (``append_n``). Each
    request's acceptance EMA sets how many drafts it asks for; the
    dispatch shape stays k. ``spec_depth="auto"`` takes
    ``core/autotune.tune_spec_depth``. Steps that carry a prompt chunk
    decode one token as before.

    ``prefix_cache=True`` (shared-prefix pages) is not ported yet and
    raises ``NotImplementedError``.
    """

    def __init__(self, model: Model, params, *, max_len: int = 512,
                 batch_size: int = 4, page_size: int = 16,
                 num_pages: int | None = None, kv_dtype=None,
                 chunk_size: int | None = None,
                 decode_reserve_frac: float = 1.0,
                 headroom_pages: int | None = None,
                 max_preemptions: int = 32, tracer=None,
                 spec_depth: int | str | None = None, spec_ngram: int = 3,
                 prefix_cache: bool = False, device="cuda"):
        if prefix_cache:
            raise NotImplementedError("prefix sharing is not ported yet")
        check_paged_support(model.cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine serves on {self.device}")
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_len = max_len
        self.batch_size = batch_size
        self.page_size = page_size
        self.kv_dtype = kv_storage_dtype(kv_dtype)
        self.max_pages = -(-max_len // page_size)
        if num_pages is None:
            num_pages = batch_size * self.max_pages + 1  # + scratch page
        self.num_pages = num_pages
        itemsize = self.cfg.compute_dtype.itemsize
        kv_itemsize = (self.kv_dtype or self.cfg.compute_dtype).itemsize
        tune = dict(b_h=self.cfg.num_heads, n_ctx=max_len, e=self.cfg.hd,
                    itemsize=itemsize, page=page_size,
                    kv_itemsize=kv_itemsize)
        if chunk_size is None:
            chunk_size = tune_prefill_chunk(**tune)
        # chunks are page-aligned and never exceed the page-rounded
        # prompt capacity
        chunk_size = max(page_size, min(chunk_size,
                                        self.max_pages * page_size))
        self.chunk_size = -(-chunk_size // page_size) * page_size
        self.chunk_pages = self.chunk_size // page_size
        if not 0.0 < decode_reserve_frac <= 1.0:
            raise ValueError(
                f"decode_reserve_frac must be in (0, 1], got "
                f"{decode_reserve_frac}")
        self.decode_reserve_frac = float(decode_reserve_frac)
        if headroom_pages is None:
            headroom_pages = (
                tune_pool_headroom(num_slots=batch_size,
                                   chunk_pages=self.chunk_pages)
                if self.decode_reserve_frac < 1.0 else 0)
        self.headroom_pages = headroom_pages
        self.max_preemptions = max_preemptions
        if spec_depth == "auto":
            spec_depth = tune_spec_depth(**tune)
        if spec_depth is not None and spec_depth < 1:
            raise ValueError(f"spec_depth must be >= 1, got {spec_depth}")
        self.spec_depth = spec_depth
        self._drafter = (NgramDrafter(ngram=spec_ngram)
                         if spec_depth is not None else None)
        self.peak_pages_used = 0  # across serve() calls
        # per-step scheduler log of the last serve() call: whether a
        # prompt chunk was packed and how many decode slots were live
        self.step_log: list[dict] = []
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = MetricsRegistry()
        self.serve_t0 = 0.0
        # fault harness: plain attributes, swapped between serve() calls
        self.injector = NO_FAULTS
        self.auditor = None
        self.results: dict[int, RequestRecord] = {}
        self._cancel_req: set[int] = set()
        self._mgr: PagedKVCacheManager | None = None

    def cancel(self, rid: int) -> None:
        """Request cancellation of ``rid``; honoured at the next step
        boundary (queued, mid-prefill or mid-decode; pages freed)."""
        self._cancel_req.add(rid)

    # -- views onto the metrics registry --------------------------------

    @property
    def token_walltimes(self) -> dict:
        """rid -> per-token wall-clock stamps, last serve() call."""
        return self.metrics.series("token_walltime_s").by_key

    @property
    def preemption_count(self) -> int:
        return int(self.metrics.counter("serving.preemptions").value)

    @property
    def recompute_tokens(self) -> int:
        return int(self.metrics.counter("serving.recompute_tokens").value)

    @property
    def spec_stats(self) -> dict:
        """Speculation of the last serve() call: drafted and accepted
        totals and the acceptance rate; zeros when speculation is off."""
        drafted = int(self.metrics.counter("spec.tokens_drafted").value)
        accepted = int(self.metrics.counter("spec.tokens_accepted").value)
        return {"drafted": drafted, "accepted": accepted,
                "acceptance_rate": accepted / drafted if drafted else 0.0}

    def kv_bytes_per_page(self) -> int:
        """Bytes one page pins across the layer stack, scales included."""
        cfg = self.cfg
        return page_footprint_bytes(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
            page_size=self.page_size, head_dim=cfg.hd,
            itemsize=(self.kv_dtype or cfg.compute_dtype).itemsize)

    # -- one engine step on the device ----------------------------------

    def _step(self, cache, host: np.ndarray, decode: bool,
              prefill: bool) -> torch.Tensor:
        """Run one step from ``host``, the step's packed int32 state:
        [tokens (B) | positions (B) | page table (B·max_pages)] when
        ``decode``, then [chunk tokens | chunk pages | the sequence's
        table row | q_offset | kv_len | last] when ``prefill`` (kv_len =
        q_offset + the chunk's live rows, last = its last live row). These
        three reach the chunk step as a slice of the step's device copy,
        so no launch argument changes with the chunk. The
        pools are updated in place. Returns the packed int32 result on the
        device: decode tokens, the chunk's first token, then their finite
        flags."""
        B, MP = self.batch_size, self.max_pages
        CS, CP = self.chunk_size, self.chunk_pages
        model, p, cfg = self.model, self.params, self.cfg
        dev = torch.from_numpy(host).to(self.device)    # the one H2D copy
        tokens, finite = [], []
        if prefill:
            off = 2 * B + B * MP if decode else 0
            first_logits, _ = model.prefill_chunk(
                p, cfg, dev[off:off + CS].long()[None], cache,
                dev[off + CS + CP:off + CS + CP + MP],
                dev[off + CS:off + CS + CP], dev[-3:])
        if decode:
            logits, _ = model.paged_decode_step(
                p, cfg, dev[:B].long()[:, None], cache,
                dev[2 * B:2 * B + B * MP].view(B, MP), dev[B:2 * B])
            last = logits[:, -1]
            tokens.append(torch.argmax(last, dim=-1))
            finite.append(_finite_rows(last))
        if prefill:
            tokens.append(torch.argmax(first_logits, dim=-1))
            finite.append(_finite_rows(first_logits))
        return torch.cat([torch.cat(tokens).to(torch.int32),
                          torch.cat(finite).to(torch.int32)])

    def _verify(self, cache, host: np.ndarray) -> torch.Tensor:
        """One verify step from ``host``, the step's packed int32 state:
        [tokens (B·k) | positions (B) | n_rows (B) | page table
        (B·max_pages)]. The pools are updated in place. Returns the packed
        int32 result on the device: the k argmaxes of every slot, then
        their k finite flags."""
        B, MP, K = self.batch_size, self.max_pages, int(self.spec_depth)
        dev = torch.from_numpy(host).to(self.device)    # the one H2D copy
        logits, _ = self.model.paged_verify_step(
            self.params, self.cfg, dev[:B * K].long().view(B, K), cache,
            dev[B * K + 2 * B:].view(B, MP), dev[B * K:B * K + B],
            dev[B * K + B:B * K + 2 * B])
        flat = logits.reshape(B * K, -1)
        return torch.cat([torch.argmax(flat, dim=-1).to(torch.int32),
                          _finite_rows(flat).to(torch.int32)])

    def serve(self, requests: list[Request]) -> dict[int, np.ndarray]:
        B, ps = self.batch_size, self.page_size
        mgr = PagedKVCacheManager(self.num_pages, ps, num_slots=B,
                                  max_pages_per_seq=self.max_pages)
        self._mgr = mgr  # auditable by tests while serve() is live
        cache = self.model.make_cache(
            B, self.max_len, device=self.device, cache_layout="paged",
            page_size=ps, num_pages=self.num_pages, kv_dtype=self.kv_dtype)
        self.step_log = []
        self.results = {}
        self._cancel_req = set()
        self.metrics = m = MetricsRegistry()
        m_occ = m.gauge("pool.pages_used",
                        "paged pool pages in use per engine step")
        m_walltimes = m.series("token_walltime_s",
                               "per-token wall-clock stamps by rid")
        m_preempt = m.counter("serving.preemptions",
                              "mid-decode evictions (pool exhaustion)")
        m_recompute = m.counter("serving.recompute_tokens",
                                "prompt+prefix tokens re-prefilled")
        m_nan = m.counter("serving.nan_guard_trips",
                          "slots failed by the finite-logit guard")
        m_tokens = m.counter("serving.tokens_generated")
        m_sync = m.histogram("engine.host_sync_s",
                             "device->host transfer wait per step")
        # "verify" only when speculation is on: a plain serve exports no
        # empty verify histogram
        step_kinds = ("decode", "chunk", "chunk+decode") + (
            ("verify",) if self.spec_depth is not None else ())
        m_step_kind = {
            k: m.histogram(f"engine.step_s.{k}",
                           "step walltime (pack+dispatch+sync) by kind")
            for k in step_kinds
        }
        m_drafted = m.counter("spec.tokens_drafted",
                              "draft candidates sent to verify steps")
        m_accepted = m.counter("spec.tokens_accepted",
                               "draft candidates matching greedy argmax")
        m_accept_rate = m.series("spec.acceptance_rate",
                                 "per-verify-step draft acceptance by rid")
        m_admit = m.series("admit_walltime_s",
                           "admission wall-clock stamp by rid")

        spec_state: dict[int, dict] = {}  # rid -> {"ema", "k"}
        tr = self.tracer
        tracing = tr.enabled
        self.serve_t0 = time.perf_counter()
        queue: deque[RequestRecord] = deque()
        for r in requests:
            rec = RequestRecord(r)
            self.results[r.rid] = rec
            _trace_request(rec, tr)
            err = validate_request(r, max_len=self.max_len,
                                   pool_pages=self.num_pages - 1,
                                   page_size=ps)
            if err:
                rec.fail(err)  # one bad request, not a dead batch
            else:
                queue.append(rec)
        active: dict[int, RequestRecord] = {}
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B,), np.int32)
        pending: list | None = None  # [rec, slot, q_offset, rprompt]
        admit_seq = itertools.count()
        n_append = 0    # global append counter (fault-injection index)
        step_idx = 0

        def idle(slot: int) -> None:
            tokens[slot, 0] = 0
            positions[slot] = 0

        def retire(slot: int) -> None:
            mgr.release(slot)
            idle(slot)

        def preempt(slot: int) -> None:
            """Evict a live decode slot: audited page release, requeue at
            the head of the queue (re-admission re-prefills prompt and
            generated tokens through the chunk path)."""
            rec = active.pop(slot)
            retire(slot)
            rec.to(RequestState.PREEMPTED)
            rec.preemptions += 1
            m_preempt.inc()
            if tracing:
                tr.instant("preempt", track="engine",
                           args={"rid": rec.rid, "tokens": len(rec.tokens)})
            if rec.preemptions > self.max_preemptions:
                rec.fail(f"preempted > {self.max_preemptions} times "
                         f"(pool thrashing)")
            else:
                rec.to(RequestState.QUEUED)
                queue.appendleft(rec)

        def recover_exhaustion(requester: int) -> None:
            """Mid-decode pool exhaustion: evict the youngest live request
            and retry until the append lands or the requester itself was
            the victim (its last token, not yet written, survives on the
            record and is re-prefilled)."""
            while True:
                victim = max(active, key=lambda s: active[s].admit_seq)
                preempt(victim)
                if victim == requester:
                    return
                try:
                    mgr.append(requester)
                    return
                except PagePoolExhausted:
                    continue

        def plan_speculation():
            """Draft and reserve pages for one verify step.

            For every live slot: how many candidate rows to verify (the
            request's adaptive k, capped by its remaining budget so the
            reservation never outgrows ``max_pages_per_seq``), a draft by
            prompt lookup, and the pages the candidate rows land in,
            allocated before the dispatch because the device writes them.
            Exhaustion preempts the youngest live request, possibly the
            reserving slot itself. Returns (tokens (B, k), n_rows (B,),
            drafts by slot).
            """
            K = int(self.spec_depth)
            vs_tokens = np.zeros((B, K), np.int32)
            n_rows = np.zeros((B,), np.int32)
            drafts: dict[int, list[int]] = {}
            for slot_i in list(active):
                if slot_i not in active:
                    continue  # evicted by an earlier slot's reservation
                rec_i = active[slot_i]
                st = spec_state.setdefault(rec_i.rid, {"ema": 1.0, "k": K})
                want = min(st["k"], rec_i.remaining, K)
                d = self._drafter.draft(
                    np.concatenate([
                        np.asarray(rec_i.request.prompt, np.int64),
                        np.asarray(rec_i.tokens, np.int64)]),
                    want - 1) if want > 1 else []
                nr = 1 + len(d)
                while slot_i in active:
                    try:
                        mgr.ensure_capacity(slot_i, nr)
                        break
                    except PagePoolExhausted:
                        preempt(max(active,
                                    key=lambda s: active[s].admit_seq))
                if slot_i not in active:
                    continue  # the reserving slot was the victim
                drafts[slot_i] = d
                vs_tokens[slot_i, 0] = tokens[slot_i, 0]
                vs_tokens[slot_i, 1:1 + len(d)] = d
                n_rows[slot_i] = nr
            self.peak_pages_used = max(self.peak_pages_used,
                                       mgr.peak_pages_used)
            return vs_tokens, n_rows, drafts

        def accept(spec_plan, token_host, ok_host, now: float) -> None:
            """The accept rule of a verify step: per slot, the longest
            prefix of drafts equal to the model's greedy argmax plus one
            token (the logits at candidate i condition on candidates
            0..i, so the stream is plain greedy's), then one ``append_n``
            commit of the kept tokens."""
            nonlocal n_append
            K = int(self.spec_depth)
            _, n_rows, drafts = spec_plan
            am = token_host.reshape(B, K)
            okm = ok_host.reshape(B, K)
            step_drafted = step_accepted = 0
            for slot_i in list(active):
                if slot_i not in active:
                    continue  # preempted by an earlier slot's fault
                rec_i = active[slot_i]
                if not okm[slot_i, :int(n_rows[slot_i])].all():
                    rec_i.fail("non-finite logits")
                    m_nan.inc()
                    del active[slot_i]
                    retire(slot_i)
                    continue
                d = drafts.get(slot_i, [])
                a = 0
                while a < len(d) and int(am[slot_i, a]) == d[a]:
                    a += 1
                emit = d[:a] + [int(am[slot_i, a])]
                if d:
                    st = spec_state[rec_i.rid]
                    rate = a / len(d)
                    # the acceptance EMA sets how many drafts to ask for:
                    # a slot whose drafts keep missing stops paying for
                    # dead verify rows
                    st["ema"] = 0.5 * st["ema"] + 0.5 * rate
                    st["k"] = 1 + int(round(st["ema"] * (K - 1)))
                    m_drafted.inc(len(d))
                    m_accepted.inc(a)
                    m_accept_rate.observe(rec_i.rid, rate)
                    step_drafted += len(d)
                    step_accepted += a
                kept, fin = 0, False
                for t in emit[:rec_i.remaining]:
                    rec_i.tokens.append(t)
                    m_walltimes.observe(rec_i.rid, now)
                    m_tokens.inc()
                    kept += 1
                    if t == rec_i.request.eos_id or rec_i.remaining <= 0:
                        fin = True
                        break
                # the pages were reserved before the dispatch, so only
                # injected faults exhaust the pool here, one chance per
                # kept token at the global append index
                evicted = False
                for _ in range(kept):
                    fault = self.injector.alloc_fault(step_idx, n_append,
                                                      slot_i)
                    n_append += 1
                    if fault:
                        victim = max(active,
                                     key=lambda s: active[s].admit_seq)
                        preempt(victim)
                        if victim == slot_i:
                            evicted = True  # kept tokens stay on the record
                            break
                if evicted:
                    continue
                mgr.append_n(slot_i, kept)      # one page-table commit
                positions[slot_i] += kept
                if fin:
                    rec_i.finish()
                    del active[slot_i]
                    retire(slot_i)
                else:
                    tokens[slot_i, 0] = rec_i.tokens[-1]
            if tracing:
                tr.instant("speculation", track="engine",
                           args={"drafted": step_drafted,
                                 "accepted": step_accepted})

        has_deadlines = any(r.deadline_s is not None for r in requests)

        def sweep_kills(now: float) -> None:
            """Cancellation and deadlines at step granularity, for queued,
            mid-prefill and mid-decode requests alike."""
            nonlocal pending
            if not self._cancel_req and not has_deadlines:
                return

            def kill_reason(rec: RequestRecord) -> str | None:
                if rec.rid in self._cancel_req:
                    return "cancelled"
                dl = rec.request.deadline_s
                if dl is not None and now - self.serve_t0 > dl:
                    return "deadline expired"
                return None

            for slot in list(active):
                reason = kill_reason(active[slot])
                if reason:
                    active.pop(slot).cancel(reason)
                    retire(slot)
            if pending is not None:
                reason = kill_reason(pending[0])
                if reason:
                    pending[0].cancel(reason)
                    retire(pending[1])
                    pending = None
            for rec in [q for q in queue if kill_reason(q)]:
                rec.cancel(kill_reason(rec))
                queue.remove(rec)

        def start_prefill() -> None:
            """Admit the head-of-queue request into a free slot (FIFO,
            reservation-based, one prefill stream at a time). Preempted
            requests sit at the head and re-prefill prompt and generated
            tokens; fresh admissions leave ``headroom_pages`` free."""
            nonlocal pending
            while queue:
                rec = queue[0]
                if rec.remaining <= 0:  # nothing (left) to generate
                    queue.popleft()
                    rec.finish()
                    continue
                rprompt = rec.resume_prompt()
                plen = len(rprompt)
                # resumed requests get their full remaining budget; fresh
                # ones reserve the configured fraction and may grow
                reserve = rec.remaining if rec.resumed else min(
                    rec.remaining,
                    max(1, int(np.ceil(rec.remaining
                                       * self.decode_reserve_frac))))
                need_total, need_new = mgr.admit_plan(plen, reserve)
                headroom = 0 if rec.resumed else max(
                    0, min(self.headroom_pages,
                           (self.num_pages - 1) - need_total))
                free = [s for s in range(B) if s not in active]
                if (not free or need_total > mgr.max_pages_per_seq
                        or need_new > mgr.available
                        or mgr.available - need_new < headroom):
                    return  # FIFO: wait for a slot or pages
                if self.injector.admit_fault(step_idx, rec.rid):
                    return  # injected admission rejection: retry later
                queue.popleft()
                slot = free[0]
                mgr.admit(slot, plen, reserve=reserve)
                if rec.admit_seq is None:
                    rec.admit_seq = next(admit_seq)
                m_admit.observe(rec.rid, time.perf_counter())
                if rec.resumed:
                    rec.recompute_tokens += plen
                    m_recompute.inc(plen)
                rec.to(RequestState.PREFILLING)
                self.peak_pages_used = max(self.peak_pages_used,
                                           mgr.peak_pages_used)
                pending = [rec, slot, 0, rprompt]
                return

        stalls = 0
        while True:
            self.injector.step_begin(self, step_idx)
            sweep_kills(time.perf_counter())
            if pending is None:
                start_prefill()
            if pending is None and not active:
                if not queue:
                    break
                # nothing live but requests queued: admission backpressure
                # with an idle engine; spin without a dead step, and give
                # up on a request the injector never lets in
                stalls += 1
                if stalls > 10_000:
                    rec = queue.popleft()
                    rec.fail("admission stalled (injected rejection)")
                    stalls = 0
                step_idx += 1
                continue
            stalls = 0
            spec_plan = None
            t_step0 = time.perf_counter()
            t_draft1 = t_step0
            if pending is None and self.spec_depth is not None:
                # a speculative step: draft and reserve before the table
                # snapshot, so the reserved pages (and any preemption the
                # reservation caused) are in it
                spec_plan = plan_speculation()
                t_draft1 = time.perf_counter()
                if tracing:
                    tr.complete("draft", tr.to_us(t_step0),
                                (t_draft1 - t_step0) * 1e6, track="engine")
            else:
                # Each live slot writes its input token's K/V row at its
                # position during the step, so the page of that row must
                # be in its table before the step: the append runs here,
                # not after the step as in the reference, where the first
                # row of a page past the decode reservation lands on the
                # scratch page.
                for slot_i in list(active):
                    if slot_i not in active:
                        continue  # preempted by an earlier slot's recovery
                    try:
                        if self.injector.alloc_fault(step_idx, n_append,
                                                     slot_i):
                            raise PagePoolExhausted(
                                f"injected exhaustion at append {n_append}")
                        mgr.append(slot_i)
                    except PagePoolExhausted:
                        recover_exhaustion(slot_i)
                    finally:
                        self.peak_pages_used = max(self.peak_pages_used,
                                                   mgr.peak_pages_used)
                    n_append += 1
            if pending is None and not active:
                step_idx += 1
                continue  # exhaustion preempted every live slot
            m_occ.record(mgr.pages_used)
            self.step_log.append({"prefill_in_flight": pending is not None,
                                  "live_decode": len(active)})
            kind = (("verify" if spec_plan is not None else "decode")
                    if pending is None
                    else ("chunk+decode" if active else "chunk"))
            if tracing:
                tr.counter("pool.pages_used", mgr.pages_used, track="pool")
            dec_table = mgr.table()
            parts = []
            if pending is not None:
                rec, slot, q0, rprompt = pending
                # mid-admission the slot must not decode into (or read
                # from) its half-written pages: point it at scratch (the
                # prefill keeps the real row, captured first)
                seq_table = dec_table[slot].copy()
                dec_table[slot] = SCRATCH_PAGE
                plen = len(rprompt)
                clen = min(self.chunk_size, plen - q0)
                ctokens = np.ones((self.chunk_size,), np.int32)
                ctokens[:clen] = rprompt[q0:q0 + clen]
                # the chunk's page span; pad pages past the allocation
                # land on the scratch page
                seq_pages = mgr.seq_pages(slot)
                p0 = q0 // ps
                cpages = [seq_pages[p] if p < len(seq_pages)
                          else SCRATCH_PAGE
                          for p in range(p0, p0 + self.chunk_pages)]
                if q0 + clen > len(seq_table) * ps:
                    raise ValueError(
                        f"rid {rec.rid}: the table's {len(seq_table)} pages "
                        f"do not cover kv_len {q0 + clen}")
                parts = [ctokens, np.asarray(cpages, np.int32), seq_table,
                         np.asarray([q0, q0 + clen, clen - 1], np.int32)]
            if spec_plan is not None:
                vs_tokens, n_rows, _ = spec_plan
                packed = self._verify(cache, np.concatenate([
                    vs_tokens.ravel(), positions, n_rows, dec_table.ravel()]))
            else:
                if active:
                    parts = [tokens[:, 0], positions,
                             dec_table.ravel()] + parts
                packed = self._step(cache, np.concatenate(parts),
                                    bool(active), pending is not None)
            t_disp = time.perf_counter()
            # the step's one device->host transfer: decode tokens, the
            # admitted request's first token and the finite-guard flags
            raw = packed.cpu().numpy()
            now = time.perf_counter()
            m_sync.observe(now - t_disp)
            m_step_kind[kind].observe(now - t_step0)
            if tracing:
                tr.complete("step", tr.to_us(t_step0),
                            (now - t_step0) * 1e6, track="engine", args={
                                "kind": kind, "step": step_idx,
                                "live_decode": len(active),
                                "chunk_tokens": (clen if pending is not None
                                                 else 0),
                                "pages_used": mgr.pages_used,
                            })
                tr.complete("dispatch", tr.to_us(t_step0),
                            (t_disp - t_step0) * 1e6, track="engine")
                tr.complete("host_sync", tr.to_us(t_disp),
                            (now - t_disp) * 1e6, track="engine")
                if spec_plan is not None:
                    # drafting ended at t_draft1; the verify dispatch and
                    # its sync fill the rest of the step
                    tr.complete("verify", tr.to_us(t_draft1),
                                (now - t_draft1) * 1e6, track="engine")
            half = raw.shape[0] // 2
            token_host = raw[:half]
            ok_host = np.asarray(
                self.injector.corrupt_step_ok(step_idx,
                                              raw[half:].astype(bool)))
            if spec_plan is not None:
                accept(spec_plan, token_host, ok_host, now)
            else:
                for slot_i in list(active.keys()):
                    rec_i = active[slot_i]
                    if not ok_host[slot_i]:
                        # NaN/inf isolation: fail this slot, free its pages,
                        # the rest of the batch decodes on
                        rec_i.fail("non-finite logits")
                        m_nan.inc()
                        del active[slot_i]
                        retire(slot_i)
                        continue
                    t = int(token_host[slot_i])
                    rec_i.tokens.append(t)
                    m_walltimes.observe(rec_i.rid, now)
                    m_tokens.inc()
                    positions[slot_i] += 1
                    if t == rec_i.request.eos_id or rec_i.remaining <= 0:
                        rec_i.finish()
                        del active[slot_i]
                        retire(slot_i)
                    else:
                        tokens[slot_i, 0] = t
            if pending is not None:
                q0 += clen
                if q0 >= plen:  # prefill complete: the first token is out
                    if not ok_host[-1]:
                        rec.fail("non-finite logits")
                        m_nan.inc()
                        retire(slot)
                    else:
                        t = int(token_host[-1])
                        rec.tokens.append(t)
                        m_walltimes.observe(rec.rid, now)
                        m_tokens.inc()
                        if t == rec.request.eos_id or rec.remaining <= 0:
                            rec.finish()  # done straight out of prefill
                            retire(slot)
                        else:
                            rec.to(RequestState.DECODING)
                            active[slot] = rec
                            tokens[slot, 0] = t
                            positions[slot] = plen
                    pending = None
                else:
                    pending[2] = q0
            if self.auditor is not None:
                expected = {s: int(positions[s]) for s in active}
                if pending is not None:
                    expected[pending[1]] = len(pending[3])
                self.auditor.check(mgr, expected_lens=expected)
            step_idx += 1
        self.peak_pages_used = max(self.peak_pages_used,
                                   mgr.peak_pages_used)
        if self.auditor is not None:
            self.auditor.final_check(mgr)
        return {rid: np.array(rec.tokens, np.int32)
                for rid, rec in self.results.items()}
