"""Qwen2-0.5B [arXiv:2407.10671]: 24L d_model=896 14H (GQA kv=2)
d_ff=4864, vocab 151936; QKV bias, tied embeddings."""
from repro_torch.models.common import ArchCfg

CONFIG = ArchCfg(
    name="qwen2-0_5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    norm="rms",
    mlp="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    full_attention=True,
    parallelism="dp_only",       # §Perf H4: 14H/2KV do not split 16-way
)
