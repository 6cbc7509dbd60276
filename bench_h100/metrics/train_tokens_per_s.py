"""train_tokens_per_s: every token of the steps in the window over the
window's seconds."""


def read(rec):
    if rec.kind != "train" or not rec.steps:
        return None
    return sum(s[2] for s in rec.steps) / rec.window_s
