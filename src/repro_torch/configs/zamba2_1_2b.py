"""Zamba2-1.2B [arXiv:2411.15242]: hybrid — 38 Mamba2 backbone layers,
one shared full-attention block (32H, MHA) applied periodically,
d_model=2048, shared-MLP d_ff=8192, ssm_state=64, vocab 32000."""
from repro_torch.models.common import ArchCfg, SsmCfg

CONFIG = ArchCfg(
    name="zamba2-1_2b",
    family="zamba2",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm=SsmCfg(d_state=64, head_dim=64, expand=2, conv_width=4),
    attn_every=6,
    norm="rms",
    mlp="gelu",
    full_attention=False,   # runs long_500k: state is O(1); shared-attn KV
                            # is the only context-linear memory
)
