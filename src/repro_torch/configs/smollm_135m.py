"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: llama-arch small,
30L d_model=576 9H (GQA kv=3) d_ff=1536, vocab 49152."""
from repro_torch.models.common import ArchCfg

CONFIG = ArchCfg(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    norm="rms",
    mlp="swiglu",
    tie_embeddings=True,
    full_attention=True,
    parallelism="dp_only",       # §Perf H4: 9H/3KV do not split 16-way
)
