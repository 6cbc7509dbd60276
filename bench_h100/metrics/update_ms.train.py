"""update_ms.train: the mean device time of the optimizer step (the
program's ``train.update`` span: leaf gradients, AdamW, the assignment
back), between CUDA events at its boundaries, over the window's steps
outside the profiled slice; none where no span carries it (the CPU)."""
from benchkit import program_spans


def read(rec):
    s = [a["dev_s"] for _, _, a in
         program_spans.quiet(rec, "train.update") or () if "dev_s" in a]
    return 1e3 * sum(s) / len(s) if s else None
