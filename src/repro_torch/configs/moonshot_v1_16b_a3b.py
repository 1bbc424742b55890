"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""

from repro_torch.models.common import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=0),
)

SMOKE = ArchConfig(
    name="moonshot-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    # capacity_factor sized so smoke batches never drop tokens; the tests
    # set lower factors where they hold drop order to the reference
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=0,
                  capacity_factor=8.0),
    attn_impl="plain",
)
