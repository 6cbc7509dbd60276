from repro_torch.data.pipeline import (Prefetcher, SyntheticTokens,  # noqa: F401
                                       make_batch_arrays)
