"""gen_tokens_per_s: every token the engine steps of the window emitted,
first tokens included, over the window's seconds."""


def read(rec):
    if rec.kind != "serve" or not rec.steps:
        return None
    return sum(s[2] for s in rec.steps) / rec.window_s
