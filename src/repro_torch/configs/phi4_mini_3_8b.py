"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""

from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
)

SMOKE = ArchConfig(
    name="phi4-mini-smoke",
    family="dense",
    num_layers=2,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    attn_impl="plain",
)
