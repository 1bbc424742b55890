"""Shared model substrate: configs, norms, rotary embeddings, init.

Port of ``repro/models/common.py`` for the dense decoder, the MoE
decoder, the SSM (mamba2), the hybrid (recurrentgemma), the vision-frontend
(internvl2) and the encoder-decoder (whisper) families. The numerics keep
the reference's op order (fp32 norm with ``1 + scale``, rope on
interleaved pairs, an fp32 sinusoid table) so the two packages agree on
logits.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 64
    top_k: int = 6
    d_expert: int = 1408
    num_shared: int = 0          # shared experts (deepseek-moe style)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    chunk: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A dense GQA decoder (SwiGLU MLP, rope), with ``family="moe"`` the
    same decoder with a routed-expert FFN (``moe``: top-k routing with
    capacity buffers, ``models/moe.py``), with ``family="ssm"`` a
    stack of mamba2 SSD blocks (``ssm``; the attention fields are
    unused), or with ``family="hybrid"`` a recurrentgemma stack: the
    layer kinds of ``block_pattern`` repeated, then ``pattern_tail``, a
    ``"rec"`` layer an RG-LRU block of width ``lru_width``
    (``models/rglru.py``) and an ``"attn"`` layer local attention over
    the last ``window`` positions, each with the MLP of ``mlp``
    (``"swiglu"``, or ``"gelu"``: up and down projections only). The
    unembedding is the embedding's transpose unless
    ``tie_embeddings`` is false, when it is a (d_model, vocab) matrix of
    its own.

    ``family="vlm"`` is the dense decoder with ``frontend="vision"``:
    ``num_frontend_tokens`` stub patch embeddings are prepended to the
    token embeddings. ``family="audio"`` is an encoder-decoder:
    ``encoder_layers`` > 0 non-causal layers over stub frames (B, F,
    d_model), and a decoder whose attention layers each add a
    cross-attention block over the encoder's output. ``rope=False``
    replaces rotary embeddings by sinusoidal positions added to the
    embeddings; ``causal`` is the decoder's self-attention mask.

    ``attn_impl`` selects the backend of the attention and SSD scan:
    ``"kernel"`` routes through ``kernels/ops.py`` (the CUDA kernels on a
    CUDA tensor, their plain versions on a CPU tensor), ``"plain"``
    through the oracles in ``kernels/ref.py`` and ``models/ssm.py``, and
    ``"chunked"`` runs full-sequence attention as the MAS dataflow in
    torch ops (``models/attention.chunked_attention``: Q chunks of
    ``attn_chunk`` rows, each a full fp32 score row, rematerialised in
    the backward when ``remat``) and everything else as ``"plain"``.
    They are the reference's ``"pallas"``, ``"xla_full"`` and ``"xla"``.
    The kernels have no backward, so training takes ``"chunked"`` (or
    ``"plain"``). ``remat`` also rematerialises each layer in the
    backward (``transformer.forward``).
    """

    name: str
    family: str      # "dense" | "moe" | "ssm" | "hybrid" | "vlm" | "audio"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads
    qk_norm: bool = False
    mlp: str = "swiglu"          # swiglu | gelu
    rope_theta: float = 10000.0
    rope: bool = True
    causal: bool = True
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid: the repeating unit of layer kinds, then the tail
    block_pattern: tuple[str, ...] | None = None   # e.g. ("rec","rec","attn")
    pattern_tail: tuple[str, ...] = ()
    window: int | None = None    # local attention span of "attn" layers
    lru_width: int | None = None
    # encoder-decoder (audio) and stub frontends (vlm, audio)
    encoder_layers: int = 0      # > 0: enc-dec; the decoder is num_layers
    frontend: str | None = None  # "vision" | "audio": stub embeddings in
    num_frontend_tokens: int = 0
    attn_impl: str = "kernel"    # kernel | plain | chunked
    attn_chunk: int = 1024       # Q rows a chunk of "chunked" attention
    remat: bool = True
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Block kind of each layer, ``"ssd"``, ``"rec"`` or ``"attn"``:
        ``block_pattern`` repeated and cut to leave room for
        ``pattern_tail``, then the tail, as the reference orders them."""
        if self.family == "ssm":
            return ("ssd",) * self.num_layers
        if self.block_pattern is None:
            return ("attn",) * self.num_layers
        body = self.num_layers - len(self.pattern_tail)
        kinds: list[str] = []
        while len(kinds) < body:
            kinds.extend(self.block_pattern)
        return tuple(kinds[:body]) + tuple(self.pattern_tail)

    @property
    def attn_window(self) -> int | None:
        """The window of the attention layers: ``window`` in a stack with
        a ``block_pattern`` (the reference sets it there only), else
        None."""
        return self.window if self.block_pattern is not None else None

    def param_count(self) -> int:
        """The parameters ``transformer.init`` draws, the unembedding when
        untied included. An SSD layer counts its conv over all conv
        channels, its gate norm and ``a_log``, which the reference's count
        leaves out; an MoE layer counts no FFN norm, which the reference's
        count adds and its init does not draw (ROADMAP C10); an RG-LRU
        layer counts its ``w_i`` and ``w_r`` (w x w each) and one ``lam``
        of w, where the reference's count leaves out both matrices and
        adds 3w (ROADMAP C12). An encoder-decoder counts each encoder
        layer's attention and MLP, each decoder layer's cross-attention
        (its norm and projections, no qk-norm) and ``enc_final_norm``,
        which the reference's count leaves out (ROADMAP C13)."""
        d, e = self.d_model, self.hd
        ffn = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff + d
        if self.moe is not None:
            m = self.moe
            ffn = (d * m.num_experts
                   + (m.num_experts + m.num_shared) * 3 * d * m.d_expert)
        hq, hkv = self.num_heads, self.num_kv_heads
        cross = d * hq * e + 2 * d * hkv * e + hq * e * d + d
        attn = cross + (2 * e if self.qk_norm else 0)
        w = self.lru_width or d
        # norm, w_x, w_gate, conv_w (4, w), w_i, w_r, lam, w_out
        rec = d + 2 * d * w + 4 * w + 2 * w * w + w + w * d
        ssd = 0
        if self.ssm is not None:
            s = self.ssm
            di = s.expand * d
            nh = di // s.head_dim
            conv_ch = di + 2 * s.n_groups * s.d_state
            ssd = (d + d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                   + s.conv_width * conv_ch + 3 * nh + di + di * d)
        layer = {"attn": attn + ffn, "rec": rec + ffn, "ssd": ssd}
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = embed + sum(layer[k] for k in self.layer_kinds) + d
        if self.encoder_layers:
            mlp = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff + d
            total += (self.encoder_layers * (attn + mlp) + d
                      + self.layer_kinds.count("attn") * cross)
        return total

    def active_param_count(self) -> int:
        """Parameters a token touches: an MoE layer's top-k routed and its
        shared experts only (the reference's formula on this count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        expert = 3 * self.d_model * m.d_expert
        n_attn = sum(k == "attn" for k in self.layer_kinds)
        return (self.param_count()
                - n_attn * (m.num_experts + m.num_shared) * expert
                + n_attn * (m.top_k + m.num_shared) * expert)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    # float32 powers of a scalar base: no host tensor is copied to the
    # device (a blocking copy would stall the host once per call)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return torch.pow(theta, -exps / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., N, E) with positions (..., N) or (N,); rotates the
    interleaved pairs (x[..., ::2], x[..., 1::2])."""
    e = x.shape[-1]
    freqs = rope_frequencies(e, theta, device=x.device)       # (E/2,)
    angles = positions[..., None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)           # (..., N, E/2)
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return y.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(N,) positions -> (N, D) fp32 table: sin on the even columns, cos
    on the odd ones, at angle ``pos / 10000 ** (2i / d)``."""
    pos = positions.float()[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    out = torch.zeros((pos.shape[0], d), dtype=torch.float32,
                      device=positions.device)
    out[:, 0::2] = torch.sin(angle)
    out[:, 1::2] = torch.cos(angle)
    return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which has
    none: ``dense_init`` draws nothing from it, only shapes."""

    device = torch.device("meta")


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by ``fan_in ** -0.5``, drawn on
    the generator's device (a ``MetaGenerator``: shapes only)."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    std = shape[in_axis] ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (w * std).to(dtype)


def embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to the compute dtype, as the reference
    multiplies the embeddings by it in that dtype."""
    return float(torch.sqrt(torch.tensor(float(d_model),
                                         dtype=torch.float32)).to(dtype))
