"""Quickstart on the PyTorch port: train a small LM end to end, restore it
from its checkpoint, and decode greedily with the trained weights.

  PYTHONPATH=src python examples/quickstart_torch.py            # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The port's counterpart of ``examples/quickstart.py``: config lookup,
trainer construction, training with periodic checkpoints, resuming from
the checkpoint, and greedy decoding with the trained parameters — the
whole train -> checkpoint -> restore -> serve loop in one file.  On the
card the attention runs through the hand-written kernels (K2 and its
backward K2-bwd); the last line gives their launches.
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    # a tiny same-family variant of an assigned arch: runs in seconds
    cfg = configs.get_config("smollm-135m").reduced()
    print(f"arch={cfg.name} family={cfg.family} "
          f"layers={cfg.n_layers} d_model={cfg.d_model} device={dev}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60)
        tcfg = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=20, batch=8,
                             seq_len=64, opt=opt, comm="single")
        trainer = Trainer(cfg, tcfg, device=dev)
        print(f"params: {trainer.n_params:,}")

        metrics = trainer.train(40)
        losses = [m["loss"] for m in metrics]
        print(f"step  1: loss {losses[0]:.4f}")
        print(f"step 40: loss {losses[-1]:.4f}")
        assert losses[-1] < losses[0], "loss should decrease"

        # --- restart from the checkpoint (simulates a new process) -----------
        trainer2 = Trainer(cfg, tcfg, device=dev)
        trainer2.resume()
        print(f"resumed at step {trainer2.data.step} "
              f"(events: {trainer2.events})")
        more = trainer2.train(10)
        assert all(np.isfinite(m["loss"]) for m in more)

        # --- greedy decode with the trained params ---------------------------
        model = api.get_model(cfg)
        params = trainer2.params
        prompt = torch.tensor([[5, 17, 42, 7]], device=dev)
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": prompt},
                                          max_len=32)
            tok = int(logits[0, -1].argmax())
            out = [tok]
            pos = prompt.shape[1]
            for _ in range(8):
                logits, cache = model.decode_step(
                    params, torch.tensor([[tok]], device=dev), cache, pos)
                tok = int(logits[0, -1].argmax())
                out.append(tok)
                pos += 1
        print("generated tokens:", out)
    print("kernel launches:", json.dumps(ops.launch_counts()))
    print("quickstart OK")


if __name__ == "__main__":
    main()
