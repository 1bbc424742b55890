"""Shared model substrate: configs, norms, rotary embeddings, init.

Port of ``repro/models/common.py`` for the dense decoder and the SSM
(mamba2) families. The numerics keep the reference's op order (fp32 norm
with ``1 + scale``, rope on interleaved pairs) so the two packages agree
on logits.
"""

from __future__ import annotations

import dataclasses

import torch


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
    """A dense GQA decoder (SwiGLU MLP, rope, tied embeddings), or with
    ``family="ssm"`` a stack of mamba2 SSD blocks (``ssm``, tied
    embeddings; the attention fields are unused).

    ``attn_impl`` selects the backend of the attention and SSD scan:
    ``"kernel"`` routes through ``kernels/ops.py`` (the CUDA kernels on a
    CUDA tensor, their plain versions on a CPU tensor), ``"plain"``
    through the oracles in ``kernels/ref.py`` and ``models/ssm.py``. They
    are the reference's ``"pallas"`` and ``"xla_full"``.
    """

    name: str
    family: str                  # "dense" | "ssm"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    ssm: SSMConfig | None = None
    attn_impl: str = "kernel"    # kernel | plain
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Block kind of each layer: ``"ssd"`` or ``"attn"``."""
        kind = "ssd" if self.family == "ssm" else "attn"
        return (kind,) * self.num_layers

    def param_count(self) -> int:
        """The parameters ``transformer.init`` draws, tied embeddings
        included. An SSD layer counts its conv over all conv channels, its
        gate norm and ``a_log``, which the reference's count leaves out."""
        d, e = self.d_model, self.hd
        if self.family == "ssm":
            s = self.ssm
            di = s.expand * d
            nh = di // s.head_dim
            conv_ch = di + 2 * s.n_groups * s.d_state
            layer = (d + d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                     + s.conv_width * conv_ch + 3 * nh + di + di * d)
        else:
            hq, hkv = self.num_heads, self.num_kv_heads
            layer = d * hq * e + 2 * d * hkv * e + hq * e * d + d
            if self.qk_norm:
                layer += 2 * e
            layer += 3 * d * self.d_ff + d
        return self.vocab_size * d + self.num_layers * layer + d


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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by ``fan_in ** -0.5``, drawn on
    the generator's device."""
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
