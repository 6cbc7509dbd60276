"""The system under test, ``repro_torch``: what every layout shares.

A configuration's layout (``layouts/<layout>.py``) builds the program's
model, serving engine and trainer on the benchmark's own weights; this
module holds what the drivers read of the program whatever its layout:
a request, the pool's use, and freeing the card.  The harness imports the
program only here and in a layout's program functions.
"""
from __future__ import annotations

import numpy as np
import torch


def pages_in_use(lm) -> tuple[int, int]:
    """(pages the slots hold, tokens their caches hold) right now."""
    return (lm.n_pages - len(lm.allocator.free),
            int(lm.seq_lens[list(lm.slot_pages)].sum()))


def request(rid: int, prompt: np.ndarray, max_new: int):
    from repro_torch.serving.engine import Request
    return Request(rid=rid, prompt=prompt, max_new_tokens=max_new)


def free_cuda() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
