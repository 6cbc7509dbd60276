"""InternVL2-76B LM backbone [arXiv:2404.16821]: 80L d_model=8192 64H
(GQA kv=8) d_ff=28672, vocab 128256.  InternViT frontend is a STUB:
input_specs supply precomputed patch embeddings."""
from repro_torch.models.common import ArchCfg

CONFIG = ArchCfg(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    n_patches=256,
    norm="rms",
    mlp="swiglu",
    full_attention=True,  # long_500k skipped
    attn_dtype="bf16",           # decode: bf16 cache ops, no GQA repeat
)
