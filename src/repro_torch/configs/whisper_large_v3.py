"""whisper-large-v3 [audio] — encoder-decoder transformer backbone.
[arXiv:2212.04356; unverified]

The conv frontend is a stub, as in the reference: the caller gives the
encoder precomputed frame embeddings (B, 1500, d_model). The decoder (32
layers) is the LM stack with a cross-attention block in each layer.
Sinusoidal positions (no rope), GELU MLP.
"""

from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,          # decoder
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    mlp="gelu",
    rope=False,
    frontend="audio",
    num_frontend_tokens=1500,
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp="gelu",
    rope=False,
    frontend="audio",
    num_frontend_tokens=16,
    attn_impl="plain",
)
