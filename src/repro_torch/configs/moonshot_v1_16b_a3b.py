"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H (GQA kv=16), MoE 64 experts top-6, expert d_ff=1408, vocab 163840."""
from repro_torch.models.common import ArchCfg, MoeCfg

CONFIG = ArchCfg(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,          # per-expert hidden
    vocab=163840,
    moe=MoeCfg(n_experts=64, top_k=6, d_expert=1408),
    norm="rms",
    mlp="swiglu",
    full_attention=True,
    moe_impl="ep_a2a",           # §Perf H2: explicit EP all-to-all
)
