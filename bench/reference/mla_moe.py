"""Plain fp32 reference of a DeepSeek-V2 decoder (arXiv:2405.04434 and
its config.json): multi-head latent attention without query compression
(``q_lora_rank`` null), the first ``first_k_dense_replace`` layers with a
dense SwiGLU MLP, the rest mixture-of-experts layers: a softmax router
over ``n_routed_experts``, the top ``num_experts_per_tok`` experts
(greedy), plus ``n_shared_experts`` shared experts as one SwiGLU MLP of
their summed width.

It follows the configuration as the program runs it (``common.runs``: the
values the port has no option for, listed under ``assumed.port_runs``):
the top-k weights renormalised to sum to 1 where ``norm_topk_prob`` says
so, no YaRN rope scaling (``rope_scaling`` null; any other is refused).
Parametrisations it shares with the port: rotate-half rotary embeddings
(DeepSeek's interleaved pairs are a permutation of the rope columns of
random weights), the embedding scaled by ``sqrt(hidden_size)`` rounded to
bf16 and norm gains ``1 + gamma``. None changes the work.

Attention is computed with K and V expanded from the latent, every
position against every earlier one. It reads the parameters in the port's
layout and imports nothing of the program.
"""
from __future__ import annotations

import torch

from bench.reference import common as C


def port_fields(hf: dict) -> dict:
    hf = C.runs(hf)
    f = hf["moe_intermediate_size"]
    return {
        "family": "moe", "attn_type": "mla", "mlp_type": "swiglu",
        "num_layers": hf["num_hidden_layers"], "d_model": hf["hidden_size"],
        "num_heads": hf["num_attention_heads"],
        "d_ff": hf["intermediate_size"], "vocab_size": hf["vocab_size"],
        "rope_theta": float(hf["rope_theta"]), "norm_eps": hf["rms_norm_eps"],
        "norm_type": "rmsnorm", "tie_embeddings": hf["tie_word_embeddings"],
        "logits_softcap": 0.0,
        "mla.kv_lora_rank": hf["kv_lora_rank"],
        "mla.q_lora_rank": hf["q_lora_rank"] or 0,
        "mla.qk_nope_head_dim": hf["qk_nope_head_dim"],
        "mla.qk_rope_head_dim": hf["qk_rope_head_dim"],
        "mla.v_head_dim": hf["v_head_dim"],
        "moe.num_experts": hf["n_routed_experts"],
        "moe.top_k": hf["num_experts_per_tok"],
        "moe.expert_d_ff": f,
        "moe.num_shared_experts": hf["n_shared_experts"],
        "moe.shared_d_ff": hf["n_shared_experts"] * f,
        "moe.first_k_dense": hf["first_k_dense_replace"],
        "moe.impl": "ragged_ep",
    }


def _check(hf: dict):
    if hf["q_lora_rank"] or hf["scoring_func"] != "softmax" \
            or hf["topk_method"] != "greedy" \
            or hf["routed_scaling_factor"] != 1 \
            or hf.get("rope_scaling") is not None:
        raise NotImplementedError("the reference follows DeepSeek-V2-Lite's "
                                  "router and attention, without rope "
                                  "scaling, only")


def work(hf: dict) -> dict:
    hf = C.runs(hf)
    d, h = hf["hidden_size"], hf["num_attention_heads"]
    nope, rope, dv = (hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                      hf["v_head_dim"])
    lora = hf["kv_lora_rank"]
    f, L, kd = (hf["moe_intermediate_size"], hf["num_hidden_layers"],
                hf["first_k_dense_replace"])
    attn = (d * h * (nope + rope) + d * (lora + rope)
            + lora * h * (nope + dv) + h * dv * d)
    dense = 3 * d * hf["intermediate_size"]
    moe = (3 * d * f * (hf["num_experts_per_tok"] + hf["n_shared_experts"])
           + d * hf["n_routed_experts"])
    return {"matmul_params": L * attn + kd * dense + (L - kd) * moe
            + d * hf["vocab_size"],
            "attn_layers": L, "heads": h, "kv_heads": h, "dq": nope + rope,
            "dv": dv}


def isolated_kernels(hf: dict, device) -> dict:
    """One grouped product at a MoE layer's expert shapes (a decode pass's
    rows spread evenly over the experts), to learn its kernels' names."""
    e, d, f = (hf["n_routed_experts"], hf["hidden_size"],
               hf["moe_intermediate_size"])
    rows = 128 * hf["num_experts_per_tok"]
    x = torch.randn(rows, d, device=device, dtype=torch.bfloat16)
    w = torch.randn(e, d, 2 * f, device=device, dtype=torch.bfloat16)
    ends = torch.arange(1, e + 1, device=device, dtype=torch.int32) \
        * (rows // e)
    return {"grouped_mm": lambda: torch._grouped_mm(x, w, offs=ends)}


def _attention(hf, p, x, precision):
    h = hf["num_attention_heads"]
    nope, rope, dv = (hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                      hf["v_head_dim"])
    eps, theta = hf["rms_norm_eps"], float(hf["rope_theta"])
    pos = torch.arange(x.shape[0], device=x.device)
    q = C.linear(x, p["wuq"], precision)                     # (s, h, nope+rope)
    q = torch.cat([q[..., :nope], C.rope(q[..., nope:], pos, theta)], -1)
    c = C.rms(C.linear(x, p["wdkv"], precision), p["kv_norm"]["gamma"], eps)
    kr = C.rope(C.linear(x, p["wkr"], precision)[:, None, :], pos, theta)
    k = torch.cat([C.linear(c, p["wuk"], precision),
                   kr.expand(-1, h, rope)], -1)
    v = C.linear(c, p["wuv"], precision)
    o = C.causal_attention(q, k, v, (nope + rope) ** -0.5)
    return C.linear(o.reshape(o.shape[0], h * dv),
                    p["wo"].reshape(h * dv, -1), precision)


def _moe(hf, p, x, precision):
    k = hf["num_experts_per_tok"]
    probs = torch.softmax(x @ p["router"].float(), -1)
    w, idx = torch.topk(probs, k, dim=-1)
    if hf["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    out = C.swiglu(x, p["shared"]["wi"], p["shared"]["wo"], precision)
    for e in range(hf["n_routed_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = C.swiglu_cat(x[rows], p["wi"][e], p["wo"][e], precision)
        out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out


def hidden(hf: dict, params: dict, seqs, precision: str = "fp32"):
    hf = C.runs(hf)
    _check(hf)
    d, eps = hf["hidden_size"], hf["rms_norm_eps"]
    dev = params["embed"].device
    xs = [params["embed"][s.to(dev).long()].float() * C.embed_scale(d)
          for s in seqs]
    kd = hf["first_k_dense_replace"]
    for i in range(hf["num_hidden_layers"]):
        key, li = ("dense_layers", i) if i < kd else ("layers", i - kd)
        p = C.layer(params, key, li, dev)
        for j, x in enumerate(xs):
            x = x + _attention(hf, p["attn"], C.rms(x, p["ln1"]["gamma"], eps),
                               precision)
            m = C.rms(x, p["ln2"]["gamma"], eps)
            if key == "dense_layers":
                x = x + C.swiglu(m, p["mlp"]["wi"], p["mlp"]["wo"], precision)
            else:
                x = x + _moe(hf, p["moe"], m, precision)
            xs[j] = x
        del p
    return xs


def logits(hf: dict, params: dict, seqs, want, precision: str = "fp32"):
    C.strict_fp32()
    hf = C.runs(hf)
    xs = hidden(hf, params, seqs, precision)
    return C.head_logits(params, xs, want, hf["rms_norm_eps"], precision)
