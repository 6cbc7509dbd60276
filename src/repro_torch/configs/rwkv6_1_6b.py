"""RWKV6 "Finch" 1.6B [arXiv:2404.05892]: attention-free, 24L
d_model=2048, channel-mix d_ff=7168, vocab 65536; 32 wkv heads of 64."""
from repro_torch.models.common import ArchCfg

CONFIG = ArchCfg(
    name="rwkv6-1_6b",
    family="rwkv6",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # wkv heads
    n_kv_heads=0,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    norm="ln",
    full_attention=False,  # O(1) state: runs long_500k
)
