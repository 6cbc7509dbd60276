"""moe_slot_use.serve: the share of the expert slots the MoE dispatch
computed that held a routed row: the program's ``moe.rows`` (T x top-k)
over its ``moe.slots`` (experts x capacity), summed over the
``engine.prefill`` and ``decode.layers`` spans of the window outside the
profiled slice.  The dropless dispatch computes every expert over every
token, so it reads top-k / experts."""
from benchkit import program_spans


def read(rec):
    rows = slots = 0
    for name in ("engine.prefill", "decode.layers"):
        for _, _, a in program_spans.quiet(rec, name) or ():
            rows += a.get("moe_rows", 0)
            slots += a.get("moe_slots", 0)
    return 100.0 * rows / slots if slots else None
