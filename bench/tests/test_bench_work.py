"""The work counts behind the rooflines and MFUs, against hand-computed
values."""
from bench import work
from bench.reference import gqa_dense, mla_moe

SH = {"matmul_params": 1000, "attn_layers": 2, "heads": 4, "kv_heads": 2,
      "dq": 8, "dv": 8}


def test_flash_counts():
    # s = 3: query i sees i + 1 keys, 6 (query, key) pairs; each pair is
    # 2*dq for Q.K and 2*dv for P.V, per head
    assert work.flash_flops(SH, 3) == 6 * 4 * (2 * 8 + 2 * 8)
    # q 3x4x8, k 3x2x8, v 3x2x8, o 3x4x8, bf16
    assert work.flash_bytes(SH, 3) == 2 * (96 + 48 + 48 + 96)


def test_paged_decode_bytes():
    # rows of 5 and 7 positions: K and V of 2 heads x 8, q and out 4 x 8
    assert work.paged_decode_bytes(SH, [5, 7]) == 2 * (
        12 * 2 * 16 + 2 * 4 * 16)


def test_step_flops():
    assert work.prefill_flops(SH, 3) == 2 * 1000 * 3 + 2 * 4 * 16 * 2 * 6
    assert work.decode_flops(SH, [5, 7]) == 2 * 1000 * 2 + 2 * 4 * 16 * 2 * 12


def test_roofline_picks_the_bound():
    p = {"flops": 10.0, "bytes_s": 2.0}
    assert work.roofline_s(100.0, 4.0, p) == 10.0
    assert work.roofline_s(10.0, 40.0, p) == 20.0
    assert work.peaks("NVIDIA H100 80GB HBM3")["flops"] == 989e12
    assert work.peaks("cpu") is None


def test_published_parameter_counts():
    import json
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / "configs"
    il = json.loads((root / "internlm2_20b.json").read_text())
    ds = json.loads((root / "deepseek_v2_lite_16b.json").read_text())
    w = gqa_dense.work(il)
    # 19.86B parameters, less the embedding's 92544 x 6144
    assert abs(w["matmul_params"] + 92544 * 6144 - 19.86e9) < 0.01e9
    w = mla_moe.work(ds)
    assert (w["heads"], w["dq"], w["dv"]) == (16, 192, 128)
    # 2.4B active parameters a token, less the embedding
    assert abs(w["matmul_params"] + 102400 * 2048 - 2.66e9) < 0.05e9
