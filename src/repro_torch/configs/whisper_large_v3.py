"""Whisper-large-v3 backbone [arXiv:2212.04356]: enc-dec, 32+32L,
d_model=1280 20H (MHA) d_ff=5120, vocab 51866.  Conv/mel frontend is a
STUB: input_specs supply precomputed 1500-frame embeddings."""
from repro_torch.models.common import ArchCfg

CONFIG = ArchCfg(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,          # decoder
    n_enc_layers=32,
    n_frames=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    norm="ln",
    mlp="gelu",
    full_attention=True,  # long_500k skipped
)
