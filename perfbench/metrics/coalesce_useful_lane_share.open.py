"""Useful lanes over dispatched lanes: each response's group size
(``info.coalesced_batch``) against the group's padded size, the next power
of two. Summed over responses, a group of n counts n useful lanes and its
padded size once."""


def read(ctx):
    rs = ctx.get("responses") or []
    if not rs:
        return None
    dispatched = sum((1 << (r["batch"] - 1).bit_length()) / r["batch"] for r in rs)
    return 100.0 * len(rs) / dispatched
