"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d_model=2048 16H (GQA kv=16)
MoE 64 experts top-8, expert d_ff=1024, vocab 50304."""
from repro_torch.models.common import ArchCfg, MoeCfg

CONFIG = ArchCfg(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,          # per-expert hidden
    vocab=50304,
    moe=MoeCfg(n_experts=64, top_k=8, d_expert=1024),
    norm="rms",
    mlp="swiglu",
    full_attention=True,
    moe_impl="ep_a2a",           # §Perf H2: explicit EP all-to-all
)
