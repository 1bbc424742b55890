"""The boundary exchanges of a prefill split by rows, with no spawn.

Ranks are threads of this process sharing a ``ThreadShard`` group (an
all-gather through a barrier), and each rank's layer is called directly
with its shard, so no process group and no sharding policy is needed:

* ``compose_states`` against the sequential recurrence it replaces;
* the SSD carry (``models/ssm.ssd_scan_split``, both scan routes) and
  the RG-LRU carry (``models/rglru.affine_scan_split``) on rank slices
  cut from one sequence, against the one-piece ``ssd_chunked`` and
  ``affine_scan`` within 1e-5 at fp32, at degrees 2-4 and rank blocks
  that are not a whole number of chunks;
* ``SeqShard.halo``'s rows (the conv's and a window's) exact, blocks
  shorter and longer than the halo;
* an SSD, an RG-LRU and a windowed attention layer on rank slices against
  the one-piece layer, and each fault of ``chip_smoke.SPLIT_FAULTS``
  rejected by ``chip_smoke.split_rows_gate``, the gate the card runs.

The whole-model split, across processes, is in
``tests/test_torch_seqshard.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.distributed.ctx import SeqShard
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import compose_states
from repro_torch.models import rglru, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5          # the scans and their carries
LAYER_TOL = 1e-4    # a layer's output: the model tests' fp32 limit
CHUNK = 16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()


class _Hub:
    """Each rank's tensor of one all-gather, behind a barrier."""

    def __init__(self, degree: int):
        self.slots = [None] * degree
        self.barrier = threading.Barrier(degree, timeout=60)

    def exchange(self, rank: int, x: torch.Tensor) -> list:
        self.slots[rank] = x.clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


@dataclasses.dataclass
class ThreadShard(SeqShard):
    """A rank of a group of threads: ``all_gather``, ``reduce_scatter``,
    ``all_reduce`` (sums in rank order), ``ring_pass`` and ``broadcast``
    through a ``_Hub``, counted as ``SeqShard``'s."""

    hub: _Hub | None = None

    def ring_pass(self, tensors, kind="ring"):
        if self.degree == 1:
            return lambda: tensors
        got = [self.hub.exchange(self.rank, t.contiguous())[self.rank - 1]
               for t in tensors]
        n = sum(t.numel() * t.element_size() for t in tensors)
        self._count(kind, n, n)
        return lambda: got

    def broadcast(self, x, src, kind="bcast"):
        if self.degree == 1:
            return x
        x.copy_(self.hub.exchange(self.rank, x)[src])
        n = x.numel() * x.element_size()
        self._count(kind, n * (self.degree - 1) if self.rank == src else 0,
                    0 if self.rank == src else n)
        return x

    def all_gather(self, x, kind):
        if self.degree == 1:
            return [x]
        n = x.numel() * x.element_size() * (self.degree - 1)
        self._count(kind, n, n)
        return self.hub.exchange(self.rank, x.contiguous())

    def reduce_scatter(self, x, kind="reduce_scatter"):
        if self.degree == 1:
            return x
        parts = self.hub.exchange(self.rank, x.contiguous())
        per = x.shape[0] // self.degree
        mine = [p[self.rank * per:(self.rank + 1) * per] for p in parts]
        out = mine[0].clone()
        for p in mine[1:]:
            out += p
        n = out.numel() * out.element_size() * (self.degree - 1)
        self._count(kind, n, n)
        return out

    def all_reduce(self, x, kind="all_reduce", op="sum"):
        if self.degree == 1:
            return x.clone()
        parts = self.hub.exchange(self.rank, x.detach())
        out = parts[0].clone()
        for p in parts[1:]:
            out = torch.maximum(out, p) if op == "max" else out + p
        n = 2 * x.numel() * x.element_size() * (self.degree - 1) \
            // self.degree
        self._count(kind, n, n)
        return out


def on_ranks(degree: int, fn) -> list:
    """``fn(shard)`` on ``degree`` threads, one a rank -> their results in
    rank order; a rank's exception is raised here."""
    hub = _Hub(degree)
    out, errors = [None] * degree, []

    def run(rank):
        try:
            out[rank] = fn(ThreadShard(None, rank, degree, hub=hub))
        except BaseException as exc:      # re-raised below
            errors.append(exc)
            hub.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(degree)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _rnd(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _rows(x: torch.Tensor, shard, dim: int = 1) -> torch.Tensor:
    per = x.shape[dim] // shard.degree
    return x.narrow(dim, shard.rank * per, per)


# ---------------------------------------------------------------------------
# the carries
# ---------------------------------------------------------------------------


def test_compose_states_is_the_sequential_recurrence():
    s0, states = _rnd(1, 3, 4, 2), _rnd(2, 3, 5, 4, 2)
    log_decays = -torch.rand(3, 5, generator=torch.Generator().manual_seed(3))
    got = compose_states(s0, states, log_decays)
    s, want = s0, [s0]
    for t in range(5):
        s = s * torch.exp(log_decays[:, t])[:, None, None] + states[:, t]
        want.append(s)
    torch.testing.assert_close(got, torch.stack(want, 1), atol=TOL, rtol=TOL)


def _ssd_inputs(length: int, heads: int = 3, p: int = 8, n: int = 4):
    x, b, c = (_rnd(s, 2, length, heads, f) for s, f in ((4, p), (5, n),
                                                         (6, n)))
    a = -torch.nn.functional.softplus(_rnd(7, 2, length, heads)) \
        * torch.linspace(1.0, 16.0, heads)
    return x, a, b, c


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("degree,block", [(2, 40), (3, 16), (4, 7), (4, 24)])
def test_ssd_carry_matches_the_one_piece_scan(degree, block, route):
    """Rank slices of one sequence (blocks of 40 and 24 rows: ragged at
    chunk 16; 7: under a chunk) scanned from zero and corrected by the
    composed carry give the one-piece scan's y and final state."""
    x, a, b, c = _ssd_inputs(degree * block)
    scan = ssm.ssd_chunked if route == "plain" else kops.ssd_chunked
    want_y, want_s = ssm.ssd_chunked(x, a, b, c, CHUNK)

    def rank(shard):
        return ssm.ssd_scan_split(scan, *(_rows(t, shard) for t in (x, a, b, c)),
                                  min(CHUNK, block), shard)

    outs = on_ranks(degree, rank)
    torch.testing.assert_close(torch.cat([y for y, _ in outs], 1), want_y,
                               atol=TOL, rtol=TOL)
    for _, s in outs:
        torch.testing.assert_close(s, want_s, atol=TOL, rtol=TOL)
        assert torch.equal(s, outs[0][1])


@pytest.mark.parametrize("degree,block", [(2, 33), (3, 8), (4, 5)])
def test_rglru_carry_matches_affine_scan(degree, block):
    length = degree * block
    log_a = -torch.rand(2, length, 6,
                        generator=torch.Generator().manual_seed(8))
    a, b = torch.exp(log_a), _rnd(9, 2, length, 6)
    want = rglru.affine_scan(a, b)

    def rank(shard):
        return rglru.affine_scan_split(*(_rows(t, shard) for t in
                                         (a, log_a, b)), shard)

    outs = on_ranks(degree, rank)
    torch.testing.assert_close(torch.cat([h for h, _ in outs], 1), want,
                               atol=TOL, rtol=TOL)
    for _, h_end in outs:
        torch.testing.assert_close(h_end, want[:, -1], atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the halos
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree,block,rows", [(2, 10, 3), (4, 2, 3),
                                               (4, 5, 31), (3, 40, 31)])
def test_halo_rows_are_exact(degree, block, rows):
    """The rows before each rank's block (up to ``rows``, spanning ranks
    when blocks are short) and the sequence's last rows, bit for bit; one
    all-gather of min(rows, block) rows a rank."""
    x = _rnd(10, 2, degree * block, 5)

    def rank(shard):
        return shard.halo(_rows(x, shard), rows), dict(shard.sent)

    for r, ((before, tail), sent) in enumerate(on_ranks(degree, rank)):
        start = r * block
        assert torch.equal(before, x[:, max(0, start - rows):start])
        assert torch.equal(tail, x[:, -min(rows, x.shape[1]):])
        assert sent["halo"] == (degree - 1) * 2 * min(rows, block) * 5 * 4


# ---------------------------------------------------------------------------
# layers on rank slices, and the planted faults
# ---------------------------------------------------------------------------


def _layer_case(arch: str, kind: str):
    cfg = dataclasses.replace(get_smoke(arch), attn_impl="kernel",
                              compute_dtype=torch.float32)
    params = build_model(cfg).init(0, device="cpu")
    index = cfg.layer_kinds.index(kind)
    layer = params["layers"][index]
    gen = torch.Generator().manual_seed(11)
    for name, leaf in layer[kind].items():
        if "norm" in name:
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 2.0)
    return cfg, layer


def _one_piece(cfg, layer, kind, x):
    if kind == "ssd":
        return ssm.ssd_block(layer["ssd"], x, cfg)[0]
    if kind == "rec":
        return rglru.rglru_block(layer["rec"], x, cfg)[0]
    positions = torch.arange(x.shape[1])
    return tfm.attn_block(layer["attn"], x, cfg, positions=positions,
                          window=cfg.attn_window)[0]


def _split(cfg, layer, kind, x, shard):
    rows = _rows(x, shard)
    if kind == "ssd":
        return ssm.ssd_block(layer["ssd"], rows, cfg, shard=shard)[0]
    if kind == "rec":
        return rglru.rglru_block(layer["rec"], rows, cfg, shard=shard)[0]
    per = rows.shape[1]
    positions = torch.arange(shard.rank * per, (shard.rank + 1) * per)
    return tfm._seq_window(layer["attn"], rows, cfg, shard, positions, True,
                           x.shape[1])


LAYERS = [("mamba2-130m", "ssd", 4, 48), ("mamba2-130m", "ssd", 2, 40),
          ("recurrentgemma-9b", "rec", 4, 24),
          ("recurrentgemma-9b", "attn", 4, 24),
          ("recurrentgemma-9b", "attn", 2, 128)]
FAULTS = {"ssd": ("carry_zeroed", "conv_halo_zeroed"),
          "rec": ("carry_zeroed", "conv_halo_zeroed"),
          "attn": ("window_halo_dropped",)}


@pytest.mark.parametrize("arch,kind,degree,block", LAYERS)
def test_split_layer_rows_and_planted_faults(arch, kind, degree, block):
    """Each rank's rows of the layer within 1e-4 of the one-piece layer's
    at those positions (a window of 32: blocks of 24 rows take a halo from
    two ranks, of 128 from one), and ``chip_smoke.split_rows_gate`` passes
    them and rejects each planted fault on every rank it touches."""
    cfg, layer = _layer_case(arch, kind)
    x = _rnd(12, 2, degree * block, cfg.d_model)
    with torch.no_grad():
        want = _one_piece(cfg, layer, kind, x)
        got = on_ranks(degree, lambda sh: _split(cfg, layer, kind, x, sh))
        faulty = {}
        for fault in FAULTS[kind]:
            with SMOKE.planted_split_fault(fault):
                faulty[fault] = on_ranks(
                    degree, lambda sh: _split(cfg, layer, kind, x, sh))
    for r in range(degree):
        mine = want[:, r * block:(r + 1) * block]
        torch.testing.assert_close(got[r], mine, atol=LAYER_TOL,
                                   rtol=LAYER_TOL)
        check = SMOKE.split_rows_gate(got[r], mine, {
            f: rows[r] if SMOKE.fault_touches(f, r, degree) else None
            for f, rows in faulty.items()})
        assert check["ok"], check
        assert any(e is not None for e in check["faults"].values()) == (r > 0)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_rows_gate_sees_every_layer_kind_on_the_split_route(arch):
    """``chip_smoke.first_outputs`` on ``layer_targets(True)`` keeps the
    first output of each layer kind the stack has when its layers run on
    the split route (``transformer._seq_mixer``), so the card's rows gate
    cannot pass by seeing no layer."""
    cfg = dataclasses.replace(get_smoke(arch), attn_impl="kernel",
                              compute_dtype=torch.float32)
    params = build_model(cfg).init(0, device="cpu")
    x = _rnd(13, 1, 64, cfg.d_model)
    shard = SeqShard(None, 0, 1)

    def run():
        with torch.no_grad():
            for layer in params["layers"]:
                tfm._seq_mixer(layer, x, cfg, shard, torch.arange(64), True,
                               64)

    _, rows = SMOKE.first_outputs(SMOKE.layer_targets(True), run)
    assert set(SMOKE.keyed(rows)) == set(cfg.layer_kinds)
