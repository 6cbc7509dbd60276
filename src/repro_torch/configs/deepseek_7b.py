"""DeepSeek-7B [arXiv:2401.02954]: llama-arch, 30L d_model=4096 32H
(MHA kv=32) d_ff=11008, vocab 102400."""
from repro_torch.models.common import ArchCfg

CONFIG = ArchCfg(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    norm="rms",
    mlp="swiglu",
    full_attention=True,
    tp_activations="manual_sp",  # §Perf H3: hand-SPMD Megatron-SP
    attn_dtype="bf16",           # bf16 wire/operands, fp32 accumulation
)
