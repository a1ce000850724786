"""The port's dry run (``repro_torch.launch.dryrun`` and its tools) against
JAX's (``repro.launch.dryrun``). The fake process group is global to a
process, so the port's cells run in a subprocess (``_PORT``), beside one
JAX subprocess with 8 host devices (``_JAX``), as
``tests/test_distributed.py`` runs JAX's dry run. Held:

* the reduced internlm2_20b ``train_4k`` cell at 4 layers on (2, 2, 2)
  (the cell of JAX's ``test_dryrun_single_cell_on_small_mesh``; JAX's
  compiled unrolled, whose cost analysis counts every layer):
  ``model_flops``, ``params_b`` and ``active_params_b`` equal JAX's,
  ``arg_bytes_per_dev`` equals JAX's ``memory_analysis`` (the layouts
  agree there), ``flops_per_dev`` within ``FLOPS_RATIO`` of JAX's;
* the wire bytes of a decode step's dense layer equal a hand count of its
  all-reduces;
* ``extrapolated_cost`` equals the count of the whole model at 6 layers,
  for each family (dense, moe, hybrid, ssm; the sLSTM's sequence
  extrapolation too);
* a MoE cell counts its experts' grouped products, at a balanced router's
  routed rows;
* ``perf_iter``'s variants give JAX's config fields;
* ``parse_dryrun_log`` inverts a printed line;
* ``roofline_report`` renders the rows as JAX's renders them.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.launch import roofline_report as jreport
from repro_torch.launch import parse_dryrun_log, roofline_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = ("baseline", "mla_absorb", "bf16_logits", "moe_dispatch",
            "moe_ragged", "shard_v2", "shard_v2_bf16", "attn_in_seqshard",
            "remat_dots", "remat_none", "chunk512")
# flops a device of the port's step over XLA's cost analysis: 0.7860
# measured (torch 2.13 CPU, jax 0.9.0). FlopCounterMode counts the matrix
# products (and the plain attention's two a head, and remat's recompute,
# as XLA does); XLA's count adds every elementwise op (norms, softmax,
# rope, AdamW), a large share at the reduced d_model of 64. Held within
# about 4% of the reading
FLOPS_RATIO = (0.75, 0.82)
ROW_KEYS = ("arch", "shape", "mesh", "n_chips", "compile_s", "flops_per_dev",
            "bytes_per_dev", "wire_bytes_per_dev", "collectives",
            "compute_term_s", "memory_term_s", "memory_term_flash_s",
            "collective_term_s", "dominant", "model_flops",
            "useful_flops_ratio", "params_b", "active_params_b",
            "arg_bytes_per_dev", "temp_bytes_per_dev", "out_bytes_per_dev")

_JAX = """
    import dataclasses, json, jax
    from repro.launch.mesh import compat_make_mesh
    from repro.launch import dryrun, perf_iter
    from repro.configs import ARCH_IDS, get_config, get_reduced_config
    mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"), shrink=True)
    assert mesh.devices.size == 8
    # unrolled, one compile: its cost analysis counts every layer
    cfg = get_reduced_config("internlm2_20b").replace(num_layers=4,
                                                      scan_layers=False)
    row = dryrun.run_cell("internlm2_20b", "train_4k", mesh, True,
                          verbose=False, cfg_override=cfg, with_cost=False)
    variants = {}
    for arch in ARCH_IDS:
        for name in VARIANTS:
            try:
                got = dataclasses.asdict(perf_iter.variant(get_config(arch),
                                                           name))
            except Exception as e:
                got = type(e).__name__
            variants[f"{arch}:{name}"] = got
    print("JSON" + json.dumps({"row": row, "variants": variants}))
"""

_PORT = """
    import dataclasses, json
    import torch
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import perf_iter
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
    from repro_torch.configs.base import ShapeConfig
    dr.fake_world(8)
    mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"),
                            device="cpu")
    out = {}
    cfg = get_reduced_config("internlm2_20b").replace(num_layers=4)
    out["row"] = dr.run_cell("internlm2_20b", "train_4k", mesh, True,
                             verbose=False, cfg_override=cfg)
    # a full-width cell for the log line (its parse reads the arch's config)
    out["full"] = dr.run_cell("gemma_2b", "decode_32k", mesh, False,
                              verbose=False)
    out["line"] = dr.log_line(out["full"])

    # one dense layer of a decode step: its all-reduces
    dec = ShapeConfig("dec", 64, 8, "decode")
    c1, c2 = (dr._cost_of(cfg.replace(num_layers=n), dec, mesh)
              for n in (1, 2))
    out["layer_wire"] = c2["wire"] - c1["wire"]
    out["layer_calls"] = c2["calls"] - c1["calls"]
    out["d_model"], out["dec_rows"] = cfg.d_model, dec.global_batch // 4

    # extrapolated == counted whole, 6 layers a family; xlstm's train step
    # at 128 tokens (its sLSTM terms from dr.SLSTM_SEQS, quadratic in the
    # sequence) without remat: its sLSTM loop is the slow part on meta
    out["extra"] = {}
    for arch, kw, seq in (("internlm2_20b", {}, 256),
                          ("deepseek_v2_lite_16b", {}, 256),
                          ("zamba2_7b", {}, 256),
                          ("xlstm_1_3b", {"remat": "none"}, 128)):
        c = get_reduced_config(arch).replace(num_layers=6, **kw)
        for shape in (ShapeConfig("t", seq, 8, "train"), dec):
            got = dr.extrapolated_cost(c, shape, mesh)
            want = dr._cost_of(c, shape, mesh)
            out["extra"][f"{arch}:{shape.name}"] = [
                [got[k], want[k]] for k in dr._TERMS]

    # the experts' grouped products of a MoE prefill at balanced routing
    from torch.utils.flop_counter import FlopCounterMode
    moe = get_reduced_config("deepseek_v2_lite_16b")
    pre = ShapeConfig("pre", 32, 8, "prefill")
    fn, args, _ = dr.build_cell(moe, pre, mesh)
    dr._register_formulas()
    with dr._balanced_routing(), FlopCounterMode(display=False) as fc:
        fn(*args)
    out["grouped"] = float(fc.get_flop_counts()["Global"].get(
        torch.ops.aten._grouped_mm, 0))
    m = moe.moe
    rows = 8 // 4 * 32                       # a rank's rows
    routed = rows * m.top_k * (m.num_experts // 2) / m.num_experts
    out["grouped_hand"] = ((moe.num_layers - m.first_k_dense) * 6.0 * routed
                           * moe.d_model * m.expert_d_ff)
    # the cell's total counts them (its flops without the formula's rows)
    out["grouped_in_total"] = dr._cost_of(moe, pre, mesh)["flops"] \\
        - float(fc.get_total_flops() - out["grouped"])

    variants = {}
    for arch in ARCH_IDS:
        for name in VARIANTS:
            try:
                got = dataclasses.asdict(perf_iter.variant(get_config(arch),
                                                           name))
            except Exception as e:
                got = type(e).__name__
            variants[f"{arch}:{name}"] = got
    out["variants"] = variants
    print("JSON" + json.dumps(out))
"""


def _popen(code: str, env_extra):
    env = dict(os.environ)
    env.update(env_extra)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", f"VARIANTS = {VARIANTS!r}\n"
         + textwrap.dedent(code)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _result(p):
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err[-4000:]
    return json.loads(out.split("JSON", 1)[1])


@pytest.fixture(scope="module")
def runs():
    j = _popen(_JAX, {"XLA_FLAGS":
                      "--xla_force_host_platform_device_count=8"})
    t = _popen(_PORT, {})
    return _result(j), _result(t)


def test_small_mesh_cell_against_jax(runs):
    jax_, port = runs
    got, want = port["row"], jax_["row"]
    assert set(ROW_KEYS) <= set(got) and set(got) - set(ROW_KEYS) == \
        {"collective_calls"}
    for k in ("arch", "shape", "mesh", "n_chips", "model_flops", "params_b",
              "active_params_b", "arg_bytes_per_dev"):
        assert got[k] == want[k], k
    ratio = got["flops_per_dev"] / want["flops_per_dev"]
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], ratio
    assert got["collectives"]["all-reduce"] > 0
    assert got["collective_calls"]["all-reduce"] > 0
    assert got["temp_bytes_per_dev"] > 0 and got["out_bytes_per_dev"] > 0


def test_wire_bytes_of_a_dense_layer_are_its_all_reduces(runs):
    """A decode step's dense layer on "model" = 2: the attention's ``wo``
    and the MLP's ``wo``, each a row-parallel sum of the rank's rows' fp32
    partials (``Layout.row_parallel``); a ring over 2 ranks sends
    2 (2 - 1) / 2 = 1 x the payload."""
    port = runs[1]
    payload = port["dec_rows"] * port["d_model"] * 4
    assert port["layer_calls"] == 2
    assert port["layer_wire"] == 2 * payload


def test_extrapolated_cost_equals_the_whole_depth_count(runs):
    for cell, terms in runs[1]["extra"].items():
        for got, want in terms:
            assert got == pytest.approx(want, rel=1e-12, abs=1e-6), cell


def test_moe_cell_counts_its_experts(runs):
    port = runs[1]
    assert port["grouped"] == port["grouped_hand"] > 0
    assert port["grouped_in_total"] == pytest.approx(port["grouped"])


def test_perf_iter_variants_give_jax_config_fields(runs):
    jax_, port = runs
    assert port["variants"].keys() == jax_["variants"].keys()
    for k, want in jax_["variants"].items():
        assert port["variants"][k] == want, k


def test_parse_dryrun_log_inverts_a_printed_line(runs, tmp_path):
    row = runs[1]["full"]
    log = tmp_path / "dry.log"
    log.write_text("noise\n" + runs[1]["line"] + "\n")
    back, = parse_dryrun_log.parse(str(log))
    for k in ("arch", "shape", "mesh", "dominant", "model_flops",
              "params_b", "active_params_b"):
        assert back[k] == row[k], k
    for k in ("compute_term_s", "memory_term_s", "memory_term_flash_s",
              "collective_term_s"):                 # printed in ms, 3 places
        assert abs(back[k] - row[k]) <= 5e-7, k
    assert back["flops_per_dev"] == pytest.approx(
        back["compute_term_s"] * 989e12)
    assert back["useful_flops_ratio"] == pytest.approx(
        row["useful_flops_ratio"], abs=5e-3)
    assert abs(back["arg_bytes_per_dev"] - row["arg_bytes_per_dev"]) <= 5e6


def test_report_renders_as_jax(runs):
    rows = [runs[1]["row"],
            {**runs[1]["row"], "mesh": "2x16x16"},
            {"arch": "x", "shape": "train_4k", "mesh": "16x16",
             "error": "NotImplementedError: y"}]
    rows[0] = {**rows[0], "mesh": "16x16"}
    assert roofline_report.render(rows) == jreport.render(rows)
    assert roofline_report.render_dryrun(rows) == jreport.render_dryrun(rows)
    assert set(roofline_report.HINTS) == set(jreport.HINTS)
    assert "shared memory" in roofline_report.HINTS[("memory",)]
