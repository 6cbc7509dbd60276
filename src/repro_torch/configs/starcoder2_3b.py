"""StarCoder2-3B [arXiv:2402.19173]: 30L d_model=3072 24H (GQA kv=2)
d_ff=12288, vocab 49152; RoPE, LayerNorm + GeLU MLP, biasful QKV."""
from repro_torch.models.common import ArchCfg

CONFIG = ArchCfg(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    norm="ln",
    mlp="gelu",
    qkv_bias=True,
    full_attention=True,
    parallelism="dp_only",       # §Perf H4: 24H/2KV do not split 16-way
)
