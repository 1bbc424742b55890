"""recurrentgemma-9b [hybrid] — RG-LRU and local attention, 2:1.
[arXiv:2402.19427; unverified]

38 layers as 12 x (rec, rec, attn) + (rec, rec); MQA (one kv head) local
attention with a 2048-token window, so the decode cache of an attention
layer is a ring of at most 2048 rows whatever the context.
"""

from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp="gelu",
    block_pattern=("rec", "rec", "attn"),
    pattern_tail=("rec", "rec"),
    window=2048,
    lru_width=4096,
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp="gelu",
    block_pattern=("rec", "rec", "attn"),
    pattern_tail=("rec", "rec"),
    window=32,
    lru_width=64,
    attn_impl="plain",
)
