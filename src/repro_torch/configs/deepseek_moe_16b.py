"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained.
[arXiv:2401.06066; hf]
"""

from repro_torch.models.common import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
)

SMOKE = ArchConfig(
    name="deepseek-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=2,
                  capacity_factor=8.0),
    attn_impl="plain",
)
