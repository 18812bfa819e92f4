"""Share of the window's decode-step calls of the decode attention island
that took the one-pass path, in % (the port's counters
``decode_attn.inplace_calls`` over it plus ``decode_attn.slab_calls``: the
kernel that writes the new token into the stored slab and mixes from it,
against the rewrite of the whole slab). None where the port counts
neither."""

from pkbench.harness import spans


def read(record):
    inplace = slab = 0
    for s in spans.steps(record) or ():
        inplace += s["counters"].get("decode_attn.inplace_calls", 0)
        slab += s["counters"].get("decode_attn.slab_calls", 0)
    return 100.0 * inplace / (inplace + slab) if inplace + slab else None
