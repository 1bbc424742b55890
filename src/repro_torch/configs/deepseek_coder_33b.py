"""deepseek-coder-33b [dense] — llama-arch GQA, untied embeddings.
[arXiv:2401.14196; hf]
"""

from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="deepseek-coder-smoke",
    family="dense",
    num_layers=2,
    d_model=112,
    num_heads=7,
    num_kv_heads=1,
    head_dim=16,
    d_ff=224,
    vocab_size=512,
    tie_embeddings=False,
    attn_impl="plain",
)
