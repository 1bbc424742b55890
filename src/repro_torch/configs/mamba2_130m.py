"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""

from repro_torch.models.common import ArchConfig, SSMConfig

ARCH = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,        # unused (attention-free)
    num_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, chunk=256),
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=1, chunk=32),
    attn_impl="plain",
)
