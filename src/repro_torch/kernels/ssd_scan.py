"""The Mamba2 SSD intra-chunk step: kernel B8, and the chunked scan
around it.

Port of ``repro/kernels/ssd_scan.py``. The chunked SSD computation
(``models/ssm.py``) splits into a quadratic intra-chunk part and a cheap
recurrence across chunks. ``ssd_intra_chunk`` computes the first for
every (batch·head, chunk) cell:

    a_cum = cumsum(a)
    L[i, j] = exp(a_cum[i] - a_cum[j]) for j <= i, else 0
    y = (C Bᵀ ⊙ L) X
    state = Σ_t exp(a_cum[-1] - a_cum[t]) b_t x_tᵀ        (N, P)

The CUDA kernels (``csrc/ssd_scan.cu``) come in two forms, chosen by
the inputs' dtype (``entry_point``). bf16 inputs run on the tensor cores
(``ssd_intra_chunk_bf16_launch``, chunks of up to ``MAX_Q_BF16`` rows):
one persistent block an SM holds a cell's bf16 C, B and X in shared
memory, brought in by tensor-map copies while the cell before is worked;
S = C Bᵀ is a ``wgmma`` product whose diagonal is summed apart in k
order, and S ⊙ L and the decay-scaled Bᵀ enter their products as bf16 hi
+ lo. fp32 inputs run on the CUDA cores (``ssd_intra_chunk_fp32_launch``,
up to ``MAX_Q`` rows), which split a chunk's rows over blocks: a whole
chunk's fp32 B and C do not fit a Hopper block's shared memory. Both
build ``a_cum`` with a sequential fp32 prefix sum, in the order of
``cumsum_sequential``: at full width a·dt reaches about -11 a step, so
``a_cum`` reaches about -3000 within a chunk and L near the diagonal is
the difference of two large fp32 numbers, which a parallel scan would
round differently.

``ssd_intra_chunk_plain`` computes the same function in PyTorch, batched
over cells, with the same prefix sum; the wrapper runs it for CPU tensors
only. ``ssd_chunked_kernel`` is the port of ``ssd_chunked_pallas``: it
flattens to cells, calls the wrapper, and runs the recurrence across
chunks in PyTorch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import NEG_INF

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts).
LAUNCHES = {"ssd_intra_chunk": 0}

MAX_Q = 2048       # chunk rows of the fp32 form (a_cum in shared memory)
MAX_Q_BF16 = 256   # chunk rows of the bf16 form (a whole cell in shared memory)
MAX_N = 128        # d_state
MAX_P = 64         # head_dim


def entry_point(dtype) -> str:
    """The C function a CUDA tensor of ``dtype`` launches: the tensor-core
    kernel in bf16, the CUDA-core kernel in fp32. Nothing falls back from
    one to the other."""
    if dtype == torch.bfloat16:
        return "ssd_intra_chunk_bf16_launch"
    if dtype == torch.float32:
        return "ssd_intra_chunk_fp32_launch"
    raise TypeError(f"B8 takes float32 or bfloat16, not {dtype}")


def cumsum_sequential(a: torch.Tensor) -> torch.Tensor:
    """fp32 prefix sum along the last axis, one addition after another
    from the first element: the order in which every block of B8 builds
    ``a_cum``. (``torch.cumsum`` accumulates in double on the CPU and in
    a parallel scan on the card.)"""
    a = a.float()
    out = torch.empty_like(a)
    run = torch.zeros_like(a[..., 0])
    for t in range(a.shape[-1]):
        run = run + a[..., t]
        out[..., t] = run
    return out


def ssd_intra_chunk_plain(x, a, b, c):
    """x: (BH, NC, Q, P); a: (BH, NC, Q); b, c: (BH, NC, Q, N) ->
    (y (BH, NC, Q, P) fp32, states (BH, NC, N, P) fp32)."""
    q = x.shape[2]
    a_cum = cumsum_sequential(a)                              # (k, c, Q)
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    below = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(torch.where(below, diff, NEG_INF))
    x, b, c = x.float(), b.float(), c.float()
    scores = torch.einsum("kcqn,kcsn->kcqs", c, b) * lmat
    y = scores @ x
    decay = torch.exp(a_cum[..., -1:] - a_cum)                # (k, c, Q)
    states = (b * decay[..., None]).transpose(-1, -2) @ x     # (k, c, N, P)
    return y, states


def ssd_intra_chunk(x, a, b, c):
    """The intra-chunk step of every (batch·head, chunk) cell. x: (BH, NC,
    Q, P) and b, c: (BH, NC, Q, N) of one dtype, fp32 or bf16; a: (BH,
    NC, Q) fp32. Returns (y (BH, NC, Q, P), states (BH, NC, N, P)), both
    fp32. A CUDA tensor launches B8 (bf16: the tensor-core form, Q up to
    ``MAX_Q_BF16``; fp32: the CUDA-core form); a CPU tensor runs the plain
    version."""
    bh, nc, q, p = x.shape
    n = b.shape[-1]
    if a.shape != (bh, nc, q) or b.shape != (bh, nc, q, n) or \
            c.shape != b.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)} disagree")
    if x.device.type == "cpu":
        return ssd_intra_chunk_plain(x, a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if b.dtype != x.dtype or c.dtype != x.dtype or a.dtype != torch.float32:
        raise ValueError("x, b and c must share one dtype, a must be fp32")
    fn = entry_point(x.dtype)
    max_q = MAX_Q_BF16 if x.dtype == torch.bfloat16 else MAX_Q
    if q > max_q or n > MAX_N or p > MAX_P or n % 8 or p % 8:
        raise ValueError(f"unsupported SSD shape: Q={q}, N={n}, P={p} "
                         f"(Q <= {max_q} in {x.dtype}, N <= {MAX_N}, "
                         f"P <= {MAX_P}, N and P multiples of 8)")
    tensors = [t.contiguous() for t in (x, a, b, c)]
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, a, b and c must share one device")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("B8 reads 16-byte words: x, a, b and c must be "
                         "16-byte aligned")
    x, a, b, c = tensors
    lib = _build.library("ssd_scan")
    y = torch.empty((bh, nc, q, p), dtype=torch.float32, device=x.device)
    states = torch.empty((bh, nc, n, p), dtype=torch.float32,
                         device=x.device)
    err = getattr(lib, fn)(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), states.data_ptr(), bh * nc, q, n, p,
        _build.stream_handle(x.device))
    _build.check(lib, err, fn)
    LAUNCHES["ssd_intra_chunk"] += 1
    return y, states


def pad_tail(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` (B, L, ...) with ``pad`` zero rows appended along L."""
    if pad == 0:
        return t
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _segsum(z: torch.Tensor) -> torch.Tensor:
    """z: (..., T) -> (..., T, T) with out[i, j] = Σ_{j < k <= i} z[k]
    for j <= i, else -inf. Each entry sums only its own terms (a
    difference of two prefix sums would lose the small segments to the
    rounding of large ones)."""
    t = z.shape[-1]
    zz = z[..., :, None].expand(*z.shape, t)                  # zz[i, j] = z[i]
    strict = torch.ones((t, t), dtype=torch.bool, device=z.device).tril(-1)
    seg = torch.where(strict, zz, 0.0).cumsum(dim=-2)
    below = torch.ones((t, t), dtype=torch.bool, device=z.device).tril()
    return torch.where(below, seg, float("-inf"))


def compose_states(s0, states, log_decays):
    """The state entering each of T segments of a scan and the state after
    the last: s0 (*batch, *feat) the state before the first segment;
    states (*batch, T, *feat) each segment's final state from a zero
    state; log_decays (*batch, T) fp32, the log of the factor each
    segment applies to a state entering it. Returns (*batch, T + 1,
    *feat) fp32 with out[i] = Σ_{j <= i} exp(Σ_{j < k <= i} z[k]) S[j],
    S = (s0, states), z = (0, log_decays): one product with a (T + 1,
    T + 1) decay matrix instead of a loop over the segments."""
    nb = log_decays.dim() - 1
    t = log_decays.shape[-1]
    feat = states.shape[nb + 1:]
    decay = torch.exp(_segsum(torch.nn.functional.pad(log_decays.float(),
                                                      (1, 0))))
    carried = torch.cat([s0.float().unsqueeze(nb), states.float()], dim=nb)
    flat = carried.reshape(*carried.shape[:nb + 1], -1)
    return (decay @ flat).reshape(*carried.shape[:nb], t + 1, *feat)


def ssd_chunked_kernel(x, a, bmat, cmat, chunk: int, initial_state=None,
                       out_dtype=None):
    """Drop-in for ``models.ssm.ssd_chunked`` with the intra-chunk part on
    ``ssd_intra_chunk``. x: (B, L, H, P); a: (B, L, H); bmat, cmat: (B, L,
    H, N); initial_state: (B, H, P, N) or None. Returns (y (B, L, H, P) in
    ``out_dtype``, by default x's dtype, final_state (B, H, P, N) fp32).

    A length that is not a multiple of ``chunk`` is padded at its tail to
    a whole chunk with zero x, B and C rows and a = 0: a padded row lies
    after every real row (it adds nothing to a real row's y), adds b·x = 0
    to its chunk's state and decays it by exp(0) = 1, so y's real rows and
    the final state are those of the unpadded sequence.

    The recurrence across chunks is ``compose_states``: one product with
    an (NC + 1, NC + 1) decay matrix instead of a loop over chunks,
    state_in[i] = Σ_{j <= i} exp(Σ_{j < k <= i} s[k]) S[j], where S =
    (initial state, chunk states) and s = (0, per-chunk sums of a). It
    equals the reference's scan up to fp32 rounding (the tests hold it to
    1e-4 at fp32).
    """
    bsz, length, h, p = x.shape
    n = bmat.shape[-1]
    pad = (-length) % chunk
    x, a, bmat, cmat = (pad_tail(t, pad) for t in (x, a, bmat, cmat))
    nc = (length + pad) // chunk

    def flat(t, feat):
        # (B, L, H, F) -> (B·H, NC, Q, F)
        t = t.reshape(bsz, nc, chunk, h, feat)
        return t.permute(0, 3, 1, 2, 4).reshape(bsz * h, nc, chunk, feat)

    af = a.float().reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2).reshape(
        bsz * h, nc, chunk)
    cf = flat(cmat, n)
    y_diag, states = ssd_intra_chunk(flat(x, p), af, flat(bmat, n), cf)

    # recurrence across chunks: one (NC + 1, NC + 1) decay matrix a cell
    s0 = (torch.zeros((bsz * h, n, p), dtype=torch.float32, device=x.device)
          if initial_state is None else
          initial_state.float().reshape(bsz * h, p, n).transpose(1, 2))
    state_in = compose_states(s0, states, af.sum(dim=2))  # (BH, NC+1, N, P)
    final = state_in[:, nc]

    # the carried-in state's contribution, decayed to each row
    decay_in = torch.exp(torch.cumsum(af, dim=2))             # (BH, NC, Q)
    y_off = (cf.float() @ state_in[:, :nc]) * decay_in[..., None]

    y = (y_diag + y_off).reshape(bsz, h, nc, chunk, p).permute(
        0, 2, 3, 1, 4).reshape(bsz, nc * chunk, h, p)[:, :length]
    final = final.transpose(1, 2).reshape(bsz, h, p, n)
    return y.to(x.dtype if out_dtype is None else out_dtype), final
