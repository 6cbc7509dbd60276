"""Faults planted in the program under test, to show the check catches
them.  Each is a hook (``cell.drive(..., hooks=...)``) that breaks the
timed path underneath the benchmark, on the program's own object."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def state_unchanged_serve(lm) -> None:
    """A decode step that returns the cache's state unchanged: the
    sequences' lengths are not advanced, so each step's K/V overwrite the
    last and later tokens lose their context."""
    decode = lm.decode_batch

    def step(tokens, active):
        lens = lm.seq_lens.copy()
        out = decode(tokens, active)
        lm.seq_lens = lens
        return out
    lm.decode_batch = step


def half_batch_serve(lm) -> None:
    """Half of the decode batch left out: the second half of the slots is
    never computed, and their tokens come back as a computed row of zero
    logits would give them."""
    decode = lm.decode_batch

    def step(tokens, active):
        keep = active.copy()
        keep[len(keep) // 2:] = False
        out = decode(tokens, keep)
        lm.seq_lens = lm.seq_lens + (active & ~keep).astype(np.int32)
        out[~keep] = 0
        return out
    lm.decode_batch = step


def token_altered_serve(lm) -> None:
    """A token altered where it is produced: every 16th decode step hands
    back each slot's next token id in place of the one chosen."""
    decode = lm.decode_batch
    n = [0]

    def step(tokens, active):
        out = decode(tokens, active)
        n[0] += 1
        if n[0] % 16 == 0:
            out = (out + 1) % lm.cfg.vocab
        return out
    lm.decode_batch = step


def state_unchanged_train(tr) -> None:
    """A step that returns its state unchanged: the update is dropped,
    whichever path makes it (the card's fused update in place, or the
    eager one): after each step the weights are put back to the seed's."""
    start = [p.detach().clone() for p in tr.params.parameters()]
    step = tr.train_step

    def unchanged(*args, **kwargs):
        out = step(*args, **kwargs)
        with torch.no_grad():
            for p, p0 in zip(tr.params.parameters(), start):
                p.copy_(p0)
        return out
    tr.train_step = unchanged


def half_batch_train(tr) -> None:
    """Half of the batch left out, the mean taken over the rest: the
    second half of each row's positions is masked out of the loss (a
    cell's batch may be a single row)."""
    loss = tr.model.train_loss

    def half(params, batch, **kw):
        lab = batch["labels"].clone()
        lab[:, lab.shape[1] // 2:] = -1
        return loss(params, dict(batch, labels=lab), **kw)
    tr.model = dataclasses.replace(tr.model, train_loss=half)


SERVE = {"state_unchanged": state_unchanged_serve,
         "half_batch": half_batch_serve,
         "token_altered": token_altered_serve}
TRAIN = {"state_unchanged": state_unchanged_train,
         "half_batch": half_batch_train}
