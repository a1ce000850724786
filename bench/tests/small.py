"""Test-sized cells (run for ``SECONDS`` after the ramp): the two families at the port's ``reduced()`` widths
and a short chat-like mix, for the CPU tests.

The program runs them in fp32 (``serve["port"]``; its caches stay bf16):
at these widths the bf16 MoE of 8 experts top-2 flips routes from
rounding alone (absorbed MLA in bf16 read widest gaps of 0-0.88 over
seeds 1-6, the fp8 control 0.04-1.35). Readings in fp32, seeds 1-6
(gqa_dense) and 1-8 (mla_moe, ~200 served tokens a sample): widest gap
0-8.4e-6 against the fp8 control's 0.109-0.203 (gqa_dense); mean gap
0-0.0002 against 0.0184-0.0292 (mla_moe; its widest still reads up to
0.75 on a backlog seed, from one flipped route)."""
from __future__ import annotations

import copy

SECONDS = 3.0
FP32 = {"param_dtype": "float32", "compute_dtype": "float32"}

GQA = {
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 256,
    "num_attention_heads": 8, "num_key_value_heads": 2,
    "num_hidden_layers": 2, "vocab_size": 512, "rms_norm_eps": 1e-05,
    "rope_theta": 1000000, "tie_word_embeddings": False,
    "reference": "gqa_dense",
    "serve": {"arch": "internlm2_20b", "max_batch": 4, "max_len": 256,
              "block_tokens": 16, "port": FP32},
    "limits": {"gap": 0.05},
}

MLA = {
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 256,
    "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
    "moe_intermediate_size": 64, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "num_hidden_layers": 3, "vocab_size": 512,
    "rms_norm_eps": 1e-05, "rope_theta": 10000, "scoring_func": "softmax",
    "topk_method": "greedy", "routed_scaling_factor": 1,
    "norm_topk_prob": False, "tie_word_embeddings": False,
    "assumed": {"port_runs": {"norm_topk_prob": True}},
    "reference": "mla_moe",
    "serve": {"arch": "deepseek_v2_lite_16b", "max_batch": 4,
              "max_len": 256, "port": {"mla.absorb": True, **FP32}},
    "limits": {"mean_gap": 0.006},
}

MIX = {
    "arrivals": {"process": "poisson", "rate": 20.0, "block_s": 0.5},
    "ramp_s": 0.5,
    "drain_s": 10.0,
    "prompt": {"median": 40, "sigma": 0.5, "min": 16, "max": 100},
    "output": {"median": 12, "sigma": 0.5, "min": 4, "max": 30},
    "check": {"requests": 16, "seq_tokens": 6000},
}


def cell(hf: dict, mix: dict = MIX, name: str = "small"):
    """A ``run.Cell`` of ``hf`` under ``mix`` with every end-to-end and
    per-layer reader of the benchmark."""
    from bench import run
    from bench.reference import gqa_dense, mla_moe
    c = run.load_cell("internlm2_20b.chat")
    ref = {"gqa_dense": gqa_dense, "mla_moe": mla_moe}[hf["reference"]]
    every = run.load_cell("deepseek_v2_lite_16b.batch")
    e2e = {n: (n, u, r) for n, u, r in c.e2e + every.e2e}
    per = {n: (n, u, r) for n, u, r in c.per_layer + every.per_layer}
    return run.Cell(name=name, chips=1, hf=copy.deepcopy(hf),
                    mix=copy.deepcopy(mix), ref=ref, e2e=list(e2e.values()),
                    per_layer=list(per.values()))


def port_cfg(hf: dict):
    """The port's reduced config with the cell's deployment choices."""
    from bench import run
    from repro_torch.configs import get_reduced_config
    return run.port_config(hf, get_reduced_config(hf["serve"]["arch"]))
