"""Pipeline parallelism: a GPipe microbatch pipeline over the ranks of a
group.

Port of ``repro/distributed/pipeline.py``. A depth-dominant model
(deepseek-coder-33b's 62 layers) can trade the tensor-parallel gathers
for point-to-point sends: the layers split into S contiguous stages, one
a rank (``stage_layers``), and M microbatches flow through them. On tick
t stage 0 takes microbatch t and stage S - 1 gives out microbatch
t - S + 1, so a run takes M + S - 1 ticks, of which each stage idles
S - 1: the bubble share (S - 1) / (M + S - 1).

Departures from the reference:

* the reference stacks its layers on axis 0 and ``shard_map`` cuts the
  stack with ``P(axis)``; the port keeps a list of per-layer trees and
  ``stage_layers`` takes the rank's block of it;
* the reference computes every stage on every tick, on zeros or stale
  rows where the tick holds no microbatch for the stage, and throws the
  result away; here such a stage skips its layers and passes its buffer
  on. No microbatch's values change: a stage's result on such a tick
  reaches no output, only the next stage's equally idle tick;
* the reference sums the outputs, masked to the last stage's, over the
  ranks (``psum``); here the last stage broadcasts them (kind ``bcast``).
  The values are the same, but for the sign of a zero: the sum turns a
  -0.0 into +0.0;
* the port has no backward through the pipeline: ``SeqShard.ring_pass``
  records no autograd node, so a backward would drop the hops without a
  word. ``pipelined_apply`` refuses a call autograd would record.

Each tick sends every stage's result to the next stage with one
``SeqShard.ring_pass`` (kind ``pipe``), the last stage's to stage 0, as
the reference's cyclic ``ppermute`` does: M + S - 1 microbatches a rank
each way.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves


def stage_layers(layers: list, shard) -> list:
    """The rank's contiguous block of ``layers`` (a list of per-layer
    trees): layers [r·L/S, (r + 1)·L/S) of L for rank r of S (all of them
    with ``shard`` None)."""
    if shard is None:
        return list(layers)
    n, s = len(layers), shard.degree
    if n % s:
        raise ValueError(f"{n} layers do not split into {s} stages")
    per = n // s
    return list(layers[shard.rank * per:(shard.rank + 1) * per])


def sequential_apply(layers: list, x: torch.Tensor, body_fn) -> torch.Tensor:
    """``body_fn(layer, h)`` applied over ``layers`` in order, from
    ``h = x``."""
    for layer in layers:
        x = body_fn(layer, x)
    return x


def _refuse_grad(layers, x) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *tree_leaves(layers)]):
        raise RuntimeError(
            "pipelined_apply has no backward (its sends record no autograd "
            "node): call it under torch.no_grad()")


def pipelined_apply(stage_layers: list, x: torch.Tensor, body_fn, shard, *,
                    num_microbatches: int) -> torch.Tensor:
    """``sequential_apply`` of every rank's ``stage_layers`` in rank order
    on ``x``, pipelined over ``shard``'s group in ``num_microbatches``
    microbatches along dim 0.

    ``x`` (B, ...) is whole on every rank (the reference's ``P()``), and
    so is the result. ``stage_layers`` is this rank's block
    (``stage_layers(layers, shard)``). With ``shard`` None, or a group of
    one, this is ``sequential_apply`` of the whole batch; over more ranks
    each microbatch's result is what ``sequential_apply`` of all the
    layers gives on that microbatch alone."""
    _refuse_grad(stage_layers, x)
    m = num_microbatches
    b = x.shape[0]
    if m < 1 or b % m:
        raise ValueError(f"a batch of {b} does not split into {m} "
                         "microbatches")
    if shard is None or shard.degree == 1:
        return sequential_apply(stage_layers, x, body_fn)
    s, stage = shard.degree, shard.rank
    xs = x.reshape(m, b // m, *x.shape[1:])
    buf = torch.zeros_like(xs[0])
    outs = torch.empty_like(xs)
    for t in range(m + s - 1):
        if stage == 0:
            buf = xs[min(t, m - 1)]
        if 0 <= t - stage < m:          # this tick holds a microbatch here
            buf = sequential_apply(stage_layers, buf, body_fn)
            if stage == s - 1:
                outs[t - stage] = buf
        buf = shard.ring_pass([buf], "pipe")()[0]
    return shard.broadcast(outs, s - 1).reshape(x.shape)
