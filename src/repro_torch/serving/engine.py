"""The wave serving engine: dense batched waves over a dense KV cache.

Port of ``ServingEngine`` from ``repro/serving/engine.py``. It groups
requests into buckets of equal prompt length, pads a wave of up to
``batch_size`` requests with dummy rows to a fixed batch, allocates a
dense (batch, max_len) cache per wave, prefills once, then decodes
greedily until every real request of the wave has stopped. Each step
moves ONE small int32 tensor from the device to the host: the live
rows' next tokens packed with the finite-logit guard's flags.

Every request runs through the lifecycle state machine of
``serving/lifecycle.py``: a malformed request becomes a FAILED result
instead of an exception, deadlines cancel a request at step granularity,
and a row whose logits are not finite fails alone while the rest of the
wave decodes on. ``engine.metrics`` (fresh per ``serve()``) holds the
per-token wall-clock stamps and step-time histograms; an enabled
``Tracer`` records per-request lifecycle spans and per-step spans.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.api import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.faults import NO_FAULTS
from repro_torch.serving.lifecycle import (
    Request,
    RequestRecord,
    RequestState,
    TERMINAL_STATES,
    validate_request,
)

__all__ = ["Request", "ServingEngine"]

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
    def __init__(self, model: Model, params, *, max_len: int = 512,
                 batch_size: int = 4, tracer=None, device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine serves on {self.device}")
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_len = max_len
        self.batch_size = batch_size
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = MetricsRegistry()
        self.serve_t0 = 0.0
        self.injector = NO_FAULTS
        self.results: dict[int, RequestRecord] = {}
        self._step_idx = 0

    def _prefill(self, tokens):
        return self.model.prefill(self.params, self.cfg, tokens, self.max_len)

    def _decode(self, cache, token, pos: int):
        return self.model.decode_step(self.params, self.cfg, token, cache,
                                      pos)

    def _next_token(self, logits, n_real: int):
        """Greedy tokens for the whole batch (dummy rows get token 1) and
        ``packed``: the live rows' tokens followed by their finite-logit
        flags in ONE int32 tensor, so a step pays a single host sync."""
        last = logits[:n_real, -1]
        live = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        finite = torch.isfinite(last).all(dim=-1).to(torch.int32)
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
