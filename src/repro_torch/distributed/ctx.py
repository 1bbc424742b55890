"""Sharding state of the multi-GPU paths, one module-level value each.

Port of ``repro/distributed/ctx.py``. Two states, each set and restored
by a context manager, no thread-local state:

* ``kv_shard(shard)`` (DESIGN.md §11): the sharded engine
  (``serving/sharded.py``) enters it around ``serve``; while it is
  active, the paged attention blocks of ``models/transformer.py`` keep
  their rank's query and KV heads, run the kernels on them against the
  rank's own pools, and all-gather the attention outputs over the
  shard's process group (``distributed/paged.py``). A chunk step takes
  ``shard.chunk_route``: ``"local"`` as decode, or ``"ring"``, the
  reference's head-block ring (``paged.ring_paged_prefill``).
* ``sharding_policy(shard, kind)``: the reference's sequence-sharding
  policy, SPMD over a ``SeqShard`` group, one process a rank. The group
  is the reference's ``'model'`` mesh axis; the port has no data or pod
  axis. Under ``"tp_sp"`` and ``"sp_rep"`` each rank holds a contiguous
  block of a sequence's rows (``seq_slice``), and the model
  (``models/transformer.py``) prefills its rows with ``ring_attention``
  (a windowed layer: with the K/V ``halo`` before them; an SSD or RG-LRU
  layer: with its conv's ``halo`` and its scan's ``carry``), keeps its
  block of the cache and decodes with ``sharded_decode_attention`` (a
  recurrent layer: on its channels and heads, the results gathered);
  the MoE FFN dispatches tokens in rank-local groups and exchanges expert
  buffers (``models/moe.py``).
  Under ``"fsdp"`` (training across ranks) the batch rows split
  instead: each rank trains on its own rows and holds dim 0 of every
  matrix cut in n blocks (``sharding.local_params(policy="fsdp")``).
  ``fsdp_state()`` gives its ``SeqShard``; ``gather_split`` gathers a
  layer's blocks whole in the compute dtype just before the layer
  (``GatherLeaf``: all-gather forward, reduce-scatter of the fp32
  gradient backward), and the train step all-reduces the gradients of
  the leaves every rank holds whole (``launch/steps.py``).
  Training under ``"tp_sp"`` (an MoE stack, or an odd batch of any
  stack) keeps the sequence split: every rank holds the whole batch and
  its ``tp_sp`` split, and the model's train route
  (``transformer.tp_sp_forward``) gathers each layer's split leaves
  along their own dims (``gather_split``), its K/V rows whole
  (``gather_rows``, whose backward reduce-scatters dK/dV), a recurrent
  layer's ``halo`` and ``carry`` (each through ``GatherLeaf`` where
  autograd records it, whose backward reduce-scatters the gradient back
  to the rank that sent the rows) and exchanges MoE buffers through
  ``AllToAll``, whose backward is the same exchange. ``train_shard()``
  gives the training policy's shard and kind.

The reference's ``constrain`` places a global array; here a rank holds
its part. ``seq_sharded_activations``, ``seq_sharded_heads`` and
``replicated_heads`` take a whole tensor and return the rows this rank
holds, keeping ``constrain``'s rule that a dim the group does not divide
stays whole. With no policy every one of them is the identity.

``SeqShard`` also carries the group's collectives, each counting the
bytes this rank sent and received by kind: ``ring`` (K/V blocks of
``ring_attention``), ``combine`` (decode partials), ``a2a`` (the MoE
expert exchange), ``gather`` (all-gathers of whole values), ``bcast``
(the last row's logits), ``weights`` (a layer's ``tp_sp`` leaves
gathered whole before the layer), ``halo`` (a layer's boundary rows: a
causal conv's inputs, a window's K/V) and ``carry`` (a recurrent
layer's scan state and decay, composed across the ranks); under
training also ``reduce_scatter`` (a gathered weight's or K/V block's
fp32 gradient summed over the ranks, each keeping its block),
``halo_grad`` and ``carry_grad`` (the same for a halo's rows and a
carry's parts),
``all_reduce`` (sums: the gradients of whole leaves, the token count,
the loss, the squared norm, an MoE layer's first-choice density) and
``all_reduce_max`` (the int8 scales' absmax); and ``pipe``, a
pipeline stage's microbatch passed to the next stage
(``distributed/pipeline.py``; its outputs' hand-out is ``bcast``).
Point-to-point
sends, all-to-alls and reduce-scatters of CUDA tensors over gloo, which
has no GPU form of them, go through host buffers, and so do its
all-reduces; ``staged_bytes`` counts the bytes copied so. Over gloo a
reduce-scatter is an all-to-all of the blocks and their sum.

A recurrent layer under the policy (``models/ssm.py``,
``models/rglru.py``) exchanges no partial sums: ``halo`` gathers each
rank's last rows so that rank r sees the rows before its first, and
``carry`` gathers each rank's scan result from a zero state and the log
of the decay its rows apply, from which every rank composes the state
entering its rows and the state after the sequence, in rank order
(``kernels/ssd_scan.compose_states``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.kernels.ssd_scan import compose_states


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# the elements of a gloo reduce-scatter staged through host memory at a
# time (``SeqShard.reduce_scatter``): 256 MB of fp32
_STAGE = 1 << 26

# NCCL's reduce-scatter: ``reduce_scatter_single``, where torch has it,
# is the new name of ``reduce_scatter_tensor`` (which then warns on every
# call)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@dataclasses.dataclass
class _Group:
    """A rank's place in a process group: ``group`` (None: the default
    group, or no group at degree 1), ``rank`` this process's index in it,
    ``degree`` its size. ``staged_bytes`` counts the bytes its ring
    passes copy through host buffers."""

    group: Any
    rank: int
    degree: int
    staged_bytes: int = 0

    def _global(self, r: int) -> int:
        """The default group's rank of group rank ``r``."""
        r %= self.degree
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def _ring_start(self, tensors: list):
        """Start sending ``tensors`` to rank + 1 and receiving the same
        shapes from rank - 1 (batched isend/irecv). Returns a function
        that waits and gives the received tensors, on the tensors'
        device, and the bytes each way."""
        staged = self._staged(tensors[0])
        out = [torch.empty(t.shape, dtype=t.dtype,
                           device="cpu" if staged else t.device)
               for t in tensors]
        ops = []
        for t, o in zip(tensors, out):
            src = t.contiguous()
            if staged:
                src = src.cpu()
                self.staged_bytes += _nbytes(src)
            ops.append(dist.P2POp(dist.isend, src, self._global(self.rank + 1),
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, o, self._global(self.rank - 1),
                                  self.group))
        works = dist.batch_isend_irecv(ops)
        dev = tensors[0].device

        def wait(_sent=ops) -> list:     # the sent buffers live until here
            for w in works:
                w.wait()
            if not staged:
                return out
            self.staged_bytes += sum(_nbytes(o) for o in out)
            return [o.to(dev) for o in out]

        return wait, sum(_nbytes(t) for t in tensors)


CHUNK_ROUTES = ("local", "ring")


@dataclasses.dataclass
class KVShard(_Group):
    """One rank's place in a KV-head-sharded group.

    ``group`` is the ``torch.distributed`` process group of the shard's
    ranks (None at degree 1, which needs none), ``rank`` this process's
    index in it and ``degree`` its size. Rank r holds KV heads
    [r·Hkv/degree, (r+1)·Hkv/degree) and the query heads that read them.
    ``chunk_route`` is how a chunk step attends: ``"local"`` (its heads
    through its pages) or ``"ring"`` (the head-block ring). The engine
    reads and clears the counts a step: ``gathered_bytes``, the bytes
    this rank's output all-gathers received from the other ranks;
    ``ring_hops``, the ring's passes; ``ring_bytes``, the slab bytes they
    received (each sent as many).
    """

    gathered_bytes: int = 0
    ring_hops: int = 0
    ring_bytes: int = 0
    chunk_route: str = "local"

    def __post_init__(self):
        if self.degree < 1 or not 0 <= self.rank < self.degree:
            raise ValueError(f"rank {self.rank} is not in a shard of "
                             f"degree {self.degree}")
        if self.chunk_route not in CHUNK_ROUTES:
            raise ValueError(f"unknown chunk route {self.chunk_route!r}; one "
                             f"of {CHUNK_ROUTES}")

    def ring_pass(self, tensors: list):
        """One hop of the head-block ring: start passing ``tensors`` to
        rank + 1 and receiving rank - 1's; a function that waits and gives
        them."""
        wait, n = self._ring_start(tensors)
        self.ring_hops += 1
        self.ring_bytes += n
        return wait


_STATE: KVShard | None = None


@contextlib.contextmanager
def kv_shard(shard: KVShard):
    """Activate KV-head sharding for the paged attention blocks; the
    previous state comes back on exit."""
    global _STATE
    prev, _STATE = _STATE, shard
    try:
        yield shard
    finally:
        _STATE = prev


def kv_shard_state() -> KVShard | None:
    """The active ``KVShard`` inside ``kv_shard``; None otherwise."""
    return _STATE


# ---------------------------------------------------------------------------
# the sequence-sharding policy
# ---------------------------------------------------------------------------

POLICIES = ("tp_sp", "sp_rep", "fsdp")
KINDS = ("ring", "combine", "a2a", "gather", "bcast", "weights", "halo",
         "carry", "reduce_scatter", "halo_grad", "carry_grad", "all_reduce",
         "all_reduce_max", "pipe")


@dataclasses.dataclass
class SeqShard(_Group):
    """One rank's place in a sequence-sharded group, and its collectives.

    ``group`` is the ``torch.distributed`` process group (None for the
    default group), ``rank`` this process's index in it and ``degree``
    its size; rank r holds rows [r·S/degree, (r+1)·S/degree) of a
    sequence the degree divides. ``sent`` and ``received`` count bytes by
    kind (``KINDS``); ``staged_bytes`` the bytes copied through host
    buffers. ``reset_counts`` clears them.
    """

    sent: dict = dataclasses.field(default_factory=dict)
    received: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.degree < 1 or not 0 <= self.rank < self.degree:
            raise ValueError(f"rank {self.rank} is not in a group of "
                             f"degree {self.degree}")
        self.reset_counts()

    def reset_counts(self) -> None:
        self.sent = dict.fromkeys(KINDS, 0)
        self.received = dict.fromkeys(KINDS, 0)
        self.staged_bytes = 0

    def _count(self, kind: str, sent: int, received: int) -> None:
        self.sent[kind] += sent
        self.received[kind] += received

    def ring_pass(self, tensors: list, kind: str = "ring"):
        """Start sending ``tensors`` to rank + 1 and receiving the same
        shapes from rank - 1. Returns a function that waits and gives the
        received tensors, on the tensors' device."""
        if self.degree == 1:
            return lambda: tensors
        wait, n = self._ring_start(tensors)
        self._count(kind, n, n)
        return wait

    def all_gather(self, x: torch.Tensor, kind: str) -> list:
        """Every rank's ``x``, in rank order."""
        if self.degree == 1:
            return [x]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.degree)]
        dist.all_gather(parts, x, group=self.group)
        n = _nbytes(x) * (self.degree - 1)
        self._count(kind, n, n)
        return parts

    def span(self, local: int, whole: int) -> slice:
        """This rank's entries of a dim of ``whole`` of which it holds
        ``local``: its block where the group split the dim, every entry
        where it stayed whole (``sharding.fit_dim``)."""
        if local == whole:
            return slice(0, whole)
        if local * self.degree != whole:
            raise ValueError(f"{local} of {whole} is no block over "
                             f"{self.degree} ranks")
        return slice(self.rank * local, (self.rank + 1) * local)

    def whole(self, x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
        """``x``, this rank's block of a dim of ``size`` entries, made whole
        by one all-gather in rank order (kind ``gather``); passed through
        where it is whole. The gathered values are each rank's bits."""
        if x.shape[dim] == size:
            return x
        return torch.cat(self.all_gather(x, "gather"), dim)

    def halo(self, x: torch.Tensor, rows: int, dim: int = 1) -> tuple:
        """The boundary rows of a sequence split in equal blocks over the
        group, ``x`` this rank's block along ``dim``: each rank's last
        min(rows, block) rows, all-gathered once (kind ``halo``). Returns
        (the up to ``rows`` rows just before this rank's first row, fewer
        near the sequence's start, none on rank 0; the sequence's last
        min(rows, S) rows). The gather is ``GatherLeaf``'s: where autograd
        records the call its backward reduce-scatters the gathered rows'
        fp32 gradient (kind ``halo_grad``), so each rank's rows receive
        what every later rank's use of them gave."""
        k = min(rows, x.shape[dim])
        every = GatherLeaf.apply(x.narrow(dim, x.shape[dim] - k, k), self,
                                 x.dtype, dim, "halo", "halo_grad")

        def last(t):
            n = min(rows, t.shape[dim])
            return t.narrow(dim, t.shape[dim] - n, n)

        return last(every.narrow(dim, 0, self.rank * k)), last(every)

    def carry(self, final: torch.Tensor, log_decay: torch.Tensor) -> tuple:
        """Compose a scan split by rows over the group: ``final`` (*batch,
        *feat) this rank's state after its rows from a zero state,
        ``log_decay`` (*batch) the log of the factor its rows apply to a
        state entering them. Both are all-gathered in one fp32 exchange
        (kind ``carry``, through ``GatherLeaf``, whose backward, where
        autograd records the call, reduce-scatters the parts' gradients,
        kind ``carry_grad``). Returns (the state entering this
        rank's rows, the state after the sequence's last row), fp32:
        every rank composes the same parts in rank order
        (``compose_states``)."""
        nb = log_decay.dim()
        flat = torch.cat([final.float().reshape(-1),
                          log_decay.float().reshape(-1)])
        parts = GatherLeaf.apply(flat, self, torch.float32, 0, "carry",
                                 "carry_grad").view(self.degree, -1)
        n_final = final.numel()
        finals = torch.stack([p[:n_final].reshape(final.shape)
                              for p in parts], dim=nb)
        decays = torch.stack([p[n_final:].reshape(log_decay.shape)
                              for p in parts], dim=-1)
        state = compose_states(torch.zeros_like(final, dtype=torch.float32),
                               finals, decays)
        return (state.select(nb, self.rank),
                state.select(nb, self.degree))

    def all_to_all(self, x: torch.Tensor, kind: str = "a2a") -> torch.Tensor:
        """``x``'s dim 0 cut in ``degree`` equal blocks, block j sent to
        rank j; the result holds rank j's block for this rank at block j."""
        if self.degree == 1:
            return x
        x = x.contiguous()
        staged = self._staged(x)
        src = x.cpu() if staged else x
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        n = _nbytes(x) * (self.degree - 1) // self.degree
        self._count(kind, n, n)
        if not staged:
            return out
        self.staged_bytes += 2 * _nbytes(x)
        return out.to(x.device)

    def gather_weights(self, tree, specs):
        """``tree`` (a dict of a params tree) with every leaf that
        ``specs`` (``sharding.split_specs``' subtree) marks (dim, whole
        size) and that holds the rank's block of it all-gathered whole
        along dim, in rank order (kind ``weights``); other leaves as they
        are, a whole tree unchanged. The gathered values are the whole
        leaf's bits."""
        if isinstance(tree, dict):
            return {k: self.gather_weights(v, specs[k])
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [self.gather_weights(v, specs[i])
                    for i, v in enumerate(tree)]
        if specs is None or tree.shape[specs[0]] == specs[1]:
            return tree
        dim, whole = specs
        if tree.shape[dim] * self.degree != whole:
            raise ValueError(f"a leaf of {tree.shape[dim]} along dim {dim} "
                             f"is no block of {whole} over {self.degree} "
                             f"ranks")
        return torch.cat(self.all_gather(tree, "weights"), dim)

    def reduce_scatter(self, x: torch.Tensor, kind: str = "reduce_scatter"
                       ) -> torch.Tensor:
        """``x``'s dim 0 cut in ``degree`` equal blocks and summed over the
        ranks; this rank's block of the sum. A rank sends and receives
        degree - 1 blocks. Over gloo, in pieces of at most ``_STAGE``
        elements of every block: an all-to-all of the pieces (through
        pinned host buffers for CUDA tensors), their sum in rank order on
        the host, and the rank's piece alone back on the tensor's device.
        A rank so holds neither the n received blocks on the card nor
        more than a piece's buffers on the host (four ranks of
        recurrentgemma-9b's whole 256000-row embedding gradient, 4.2 GB
        fp32 each, ran out of the card's memory, then of the host's, on
        one H100): gloo's own reduce-scatter took 2.6 times as long on one
        H100's four ranks (``scripts/gloo_transport.py``)."""
        if self.degree == 1:
            return x
        if x.shape[0] % self.degree:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                             f"{self.degree} ranks")
        x = x.contiguous()
        per = (x.shape[0] // self.degree,) + x.shape[1:]
        n = _nbytes(x) // self.degree * (self.degree - 1)
        self._count(kind, n, n)
        if dist.get_backend(self.group) != "gloo":
            out = x.new_empty(per)
            _REDUCE_SCATTER(out, x, group=self.group)
            return out
        blocks = x.view(self.degree, -1)
        out = x.new_empty(per)
        flat = out.view(-1)
        step = max(1, _STAGE // self.degree)
        for at in range(0, blocks.shape[1], step):
            src = self._to_host(blocks[:, at:at + step].contiguous())
            parts = torch.empty_like(src)
            dist.all_to_all_single(parts, src, group=self.group)
            piece = parts[0].clone()
            for part in parts[1:]:
                piece += part
            flat[at:at + step].copy_(self._to_device(piece, x))
        return out

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself on the CPU; a CUDA tensor copied into pinned host
        memory (counted in ``staged_bytes``)."""
        if not x.is_cuda:
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        self.staged_bytes += _nbytes(x)
        return host

    def _to_device(self, host: torch.Tensor, like: torch.Tensor
                   ) -> torch.Tensor:
        """``host`` back on ``like``'s device (counted where it moves)."""
        if not like.is_cuda:
            return host
        self.staged_bytes += _nbytes(host)
        return host.to(like.device, non_blocking=True)

    def all_reduce(self, x: torch.Tensor, kind: str = "all_reduce",
                   op: str = "sum") -> torch.Tensor:
        """``x`` summed (``op="max"``: its maximum) over the ranks,
        elementwise; a new tensor, the same bits on every rank. Counted as
        a reduce-scatter and an all-gather: 2 (n - 1) / n of its bytes each
        way."""
        if self.degree == 1:
            return x.clone()
        staged = self._staged(x)
        out = self._to_host(x.detach()) if staged else x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        n = 2 * _nbytes(x) * (self.degree - 1) // self.degree
        self._count(kind, n, n)
        return self._to_device(out, x) if staged else out

    def broadcast(self, x: torch.Tensor, src: int, kind: str = "bcast"
                  ) -> torch.Tensor:
        """``x`` of group rank ``src`` on every rank (in place)."""
        if self.degree == 1:
            return x
        dist.broadcast(x, self._global(src), group=self.group)
        n = _nbytes(x)
        if self.rank == src:
            self._count(kind, n * (self.degree - 1), 0)
        else:
            self._count(kind, 0, n)
        return x


_POLICY: tuple[SeqShard, str] | None = None


@contextlib.contextmanager
def sharding_policy(shard: SeqShard, kind: str = "tp_sp"):
    """Activate the sequence-sharding policy ``kind`` over ``shard``'s
    group (``POLICIES``); the previous policy comes back on exit."""
    global _POLICY
    if kind not in POLICIES:
        raise ValueError(f"unknown sharding policy {kind!r}; one of "
                         f"{POLICIES}")
    prev, _POLICY = _POLICY, (shard, kind)
    try:
        yield shard
    finally:
        _POLICY = prev


def seq_shard_state() -> SeqShard | None:
    """The active policy's ``SeqShard``; None with no policy."""
    return None if _POLICY is None else _POLICY[0]


def fsdp_state() -> SeqShard | None:
    """The active policy's ``SeqShard`` under ``fsdp``; None otherwise."""
    return _POLICY[0] if _POLICY is not None and _POLICY[1] == "fsdp" \
        else None


class GatherLeaf(torch.autograd.Function):
    """A tensor split along ``dim`` over ``shard``'s group, gathered
    whole in ``dtype``: the rank's block cast to ``dtype`` and all-gathered
    in rank order (kind ``kind``: ``weights`` for a split parameter,
    ``gather`` for a sequence's K/V rows, ``halo`` and ``carry`` for a
    split layer's boundary rows and scan state). Backward: the whole
    tensor's gradient in fp32, summed over the ranks by a reduce-scatter
    along ``dim`` (kind ``grad_kind``), the rank's block of the sum as its
    block's gradient, in the block's dtype."""

    @staticmethod
    def forward(ctx_, block, shard, dtype, dim=0, kind="weights",
                grad_kind="reduce_scatter"):
        ctx_.shard, ctx_.dim, ctx_.dtype, ctx_.kind = (shard, dim,
                                                       block.dtype, kind)
        ctx_.grad_kind = grad_kind
        return torch.cat(shard.all_gather(block.detach().to(dtype), kind),
                         dim)

    @staticmethod
    def backward(ctx_, grad):
        whole = grad.float().movedim(ctx_.dim, 0).contiguous()
        block = ctx_.shard.reduce_scatter(whole, ctx_.grad_kind).movedim(
            0, ctx_.dim)
        return block.to(ctx_.dtype), None, None, None, None, None


class AllToAll(torch.autograd.Function):
    """``SeqShard.all_to_all`` (kind ``a2a``) with its backward: the
    gradient's blocks sent back by the same exchange, which is its own
    inverse over blocks of equal size."""

    @staticmethod
    def forward(ctx_, x, shard):
        ctx_.shard = shard
        return shard.all_to_all(x.detach())

    @staticmethod
    def backward(ctx_, grad):
        return ctx_.shard.all_to_all(grad), None


def gather_split(tree, specs, shard: SeqShard, dtype):
    """``tree`` (a part of a params tree) with each leaf that ``specs``
    (``sharding.split_specs(cfg, n, policy)``' matching part) marks (dim,
    whole size) and that holds the rank's block of it gathered whole
    along dim (``GatherLeaf``, kind ``weights``), and every other fp32
    leaf of two or more dims cast to ``dtype``, as ``Model.loss_fn`` casts
    weights on one card; 1-D leaves as they are. Training's gather: under
    ``fsdp`` dim 0 of every matrix, under ``tp_sp`` the leaf's
    tensor-parallel dim (a rank's experts are not marked: they stay its
    own)."""
    if isinstance(tree, dict):
        return {k: gather_split(v, specs[k], shard, dtype)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_split(v, specs[i], shard, dtype)
                for i, v in enumerate(tree)]
    if specs is not None and tree.shape[specs[0]] != specs[1]:
        dim, whole = specs
        if tree.shape[dim] * shard.degree != whole:
            raise ValueError(f"a leaf of {tree.shape[dim]} along dim {dim} "
                             f"is no block of {whole} over {shard.degree} "
                             f"ranks")
        return GatherLeaf.apply(tree, shard, dtype, dim)
    if tree.dtype == torch.float32 and tree.dim() >= 2:
        return tree.to(dtype)
    return tree


def gather_rows(x: torch.Tensor, shard: SeqShard, dim: int) -> torch.Tensor:
    """``x``, the rank's block of a sequence split along ``dim``, made
    whole by one all-gather in rank order (kind ``gather``); the backward
    reduce-scatters its gradient (``GatherLeaf``)."""
    return GatherLeaf.apply(x, shard, x.dtype, dim, "gather")


def train_shard() -> tuple:
    """(the active training policy's ``SeqShard``, its kind): under
    ``fsdp``, or under ``tp_sp`` with a group; (None, None) otherwise."""
    shard = fsdp_state()
    if shard is not None:
        return shard, "fsdp"
    shard = seq_shard_state()
    if shard is not None and policy_kind() == "tp_sp":
        return shard, "tp_sp"
    return None, None


def policy_kind() -> str:
    """The active policy's kind; ``"tp_sp"`` with none, as the
    reference's default."""
    return "tp_sp" if _POLICY is None else _POLICY[1]


def batch_axes() -> tuple[str, ...]:
    """The mesh axes the batch splits over: the group (``'model'``) under
    ``fsdp``, none otherwise (the port has no data or pod axis)."""
    return ("model",) if _POLICY is not None and _POLICY[1] == "fsdp" else ()


def zero_front(t: torch.Tensor, rows: int, dim: int = 1) -> torch.Tensor:
    """``t`` with zero rows put before it along ``dim`` to make ``rows``:
    a causal conv's state where the sequence starts."""
    pad = rows - t.shape[dim]
    if pad == 0:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t.new_zeros(shape), t], dim)


def divides(n: int) -> bool:
    """``constrain``'s rule: the active group splits a dim of ``n`` only
    when its degree divides it (always true with no policy)."""
    shard = seq_shard_state()
    return shard is None or n % shard.degree == 0


def _block(n: int) -> slice:
    shard = seq_shard_state()
    if shard is None or not divides(n):
        return slice(0, n)
    per = n // shard.degree
    return slice(shard.rank * per, (shard.rank + 1) * per)


def seq_slice(s: int) -> slice:
    """The rows of a length-``s`` sequence this rank holds: its block
    under ``tp_sp``/``sp_rep`` when the degree divides ``s``, else all."""
    if policy_kind() == "fsdp":
        return slice(0, s)
    return _block(s)


def _rows(x: torch.Tensor, seq_dim: int) -> torch.Tensor:
    dim = 0 if policy_kind() == "fsdp" else seq_dim
    sl = _block(x.shape[dim])
    if sl.stop - sl.start == x.shape[dim]:
        return x
    return x.narrow(dim, sl.start, sl.stop - sl.start)


def seq_sharded_activations(x: torch.Tensor) -> torch.Tensor:
    """(B, S, ...) hidden rows (or tokens): the rank's sequence block
    (under ``fsdp``: its batch block), whole where the degree does not
    divide."""
    return _rows(x, 1)


def seq_sharded_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, E): the rank's sequence block, heads whole (under
    ``fsdp``: its batch block)."""
    return _rows(x, 2)


def replicated_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, E) K/V replicated over the sequence: every row (under
    ``fsdp``: the rank's batch block)."""
    return _rows(x, 0) if policy_kind() == "fsdp" else x


_GROUPING: int = 1


@contextlib.contextmanager
def grouped_as(degree: int):
    """With no policy active, dispatch MoE tokens in the groups a
    ``tp_sp`` group of ``degree`` ranks forms, on this one device, with
    no exchange (``models/moe.py``): the single-card yardstick of a
    sharded MoE run."""
    global _GROUPING
    if degree < 1:
        raise ValueError(f"degree {degree} < 1")
    prev, _GROUPING = _GROUPING, degree
    try:
        yield
    finally:
        _GROUPING = prev


def grouping_degree() -> int:
    """The degree MoE tokens group by: the policy's, else ``grouped_as``'s
    (1 outside both)."""
    shard = seq_shard_state()
    return _GROUPING if shard is None else shard.degree
