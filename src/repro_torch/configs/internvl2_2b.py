"""internvl2-2b [vlm] — InternViT frontend (stub) + InternLM2 backbone.
[arXiv:2404.16821; hf]

The vision frontend is a stub, as in the reference: the caller gives
precomputed patch embeddings (B, 256, d_model), which are prepended to
the token embeddings.
"""

from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    mlp="swiglu",
    frontend="vision",
    num_frontend_tokens=256,
)

SMOKE = ArchConfig(
    name="internvl2-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp="swiglu",
    frontend="vision",
    num_frontend_tokens=8,
    attn_impl="plain",
)
