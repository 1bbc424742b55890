"""internlm2-1.8b [dense] — GQA. [arXiv:2403.17297; hf]"""

from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
)

SMOKE = ArchConfig(
    name="internlm2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    attn_impl="plain",
)
