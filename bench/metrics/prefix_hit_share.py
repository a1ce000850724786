"""KV manager (``engine/paged_kv.py``): the window's growth of
``kv_stats()["prefix_hit_tokens"]`` over the prompt tokens it prefilled.
Nothing where the engine keeps no paged store."""


def read(rec):
    toks = sum(p["tokens"] for p in rec.prefills)
    if rec.kv0 is None or rec.kv1 is None or not toks:
        return None
    return 100.0 * (rec.kv1["prefix_hit_tokens"] - rec.kv0["prefix_hit_tokens"]) / toks
