"""Plain fp32 reference of a dense decoder with grouped-query attention and
a SwiGLU MLP (InternLM2, as in arXiv:2403.17297 and its config.json):
pre-norm blocks, RMS norms, rotate-half rotary embeddings, causal softmax
attention with ``num_key_value_heads`` shared K/V heads, untied head.

Departures of the port that the reference follows, none of which changes
the work: the embedding is scaled by ``sqrt(hidden_size)`` rounded to
bf16, and each norm's gain is ``1 + gamma`` (both parametrisations of
random weights); Q, K and V are three leaves, not InternLM2's fused
``wqkv``.

It reads the parameters in the port's layout (dotted keys below) and
imports nothing of the program.
"""
from __future__ import annotations

import torch

from bench.reference import common as C


def port_fields(hf: dict) -> dict:
    """The port's ``ModelConfig`` fields that must equal the file."""
    return {
        "family": "dense", "attn_type": "gqa", "mlp_type": "swiglu",
        "num_layers": hf["num_hidden_layers"], "d_model": hf["hidden_size"],
        "num_heads": hf["num_attention_heads"],
        "num_kv_heads": hf["num_key_value_heads"],
        "resolved_head_dim": hf["hidden_size"] // hf["num_attention_heads"],
        "d_ff": hf["intermediate_size"], "vocab_size": hf["vocab_size"],
        "rope_theta": float(hf["rope_theta"]), "norm_eps": hf["rms_norm_eps"],
        "norm_type": "rmsnorm", "tie_embeddings": hf["tie_word_embeddings"],
        "logits_softcap": 0.0,
    }


def work(hf: dict) -> dict:
    """Shapes the benchmark counts FLOPs and bytes from."""
    d, f = hf["hidden_size"], hf["intermediate_size"]
    h, kvh = hf["num_attention_heads"], hf["num_key_value_heads"]
    hd = d // h
    L = hf["num_hidden_layers"]
    per_layer = d * h * hd * 2 + 2 * d * kvh * hd + 3 * d * f
    return {"matmul_params": L * per_layer + d * hf["vocab_size"],
            "attn_layers": L, "heads": h, "kv_heads": kvh, "dq": hd,
            "dv": hd}


def isolated_kernels(hf: dict, device) -> dict:
    return {}


def hidden(hf: dict, params: dict, seqs, precision: str = "fp32"):
    """Last hidden states (before the final norm) of each token sequence
    in ``seqs`` (1-d int tensors), layer by layer over all of them."""
    d, h = hf["hidden_size"], hf["num_attention_heads"]
    kvh, hd = hf["num_key_value_heads"], d // h
    eps, theta = hf["rms_norm_eps"], float(hf["rope_theta"])
    dev = params["embed"].device
    emb = params["embed"]
    xs = [emb[s.to(dev).long()].float() * C.embed_scale(d) for s in seqs]
    for i in range(hf["num_hidden_layers"]):
        p = C.layer(params, "layers", i, dev)
        for j, x in enumerate(xs):
            pos = torch.arange(x.shape[0], device=dev)
            a = C.rms(x, p["ln1"]["gamma"], eps)
            q = C.rope(C.linear(a, p["attn"]["wq"], precision), pos, theta)
            k = C.rope(C.linear(a, p["attn"]["wk"], precision), pos, theta)
            v = C.linear(a, p["attn"]["wv"], precision)
            k = k.repeat_interleave(h // kvh, dim=1)
            v = v.repeat_interleave(h // kvh, dim=1)
            o = C.causal_attention(q, k, v, hd ** -0.5)
            x = x + C.linear(o.reshape(o.shape[0], h * hd),
                             p["attn"]["wo"].reshape(h * hd, d), precision)
            m = C.rms(x, p["ln2"]["gamma"], eps)
            xs[j] = x + C.swiglu(m, p["mlp"]["wi"], p["mlp"]["wo"], precision)
        del p
    return xs


def logits(hf: dict, params: dict, seqs, want, precision: str = "fp32"):
    """fp32 logits of each sequence at its positions ``want[j]``."""
    C.strict_fp32()
    xs = hidden(hf, params, seqs, precision)
    return C.head_logits(params, xs, want, hf["rms_norm_eps"], precision)
