"""The port's ``perfmodel`` against the JAX package's: the hardware specs
and the IVF-PQ retrieval costs field for field, every analytical function
equal over every registered config, and the ridge fits' predictions
within a stated multiple of JAX's own fp32 error."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced_config as jget_reduced
from repro.perfmodel import analytical as jana
from repro.perfmodel import hardware as jhw
from repro.perfmodel import rag_model as jrag
from repro.perfmodel import regression as jreg

from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.perfmodel import analytical as ana
from repro_torch.perfmodel import hardware as hw
from repro_torch.perfmodel import rag_model as rag
from repro_torch.perfmodel import regression as reg

TIERS = ("TIER_LOCAL_LPDDR", "TIER_PLATFORM", "TIER_RACK", "TIER_HOST_DRAM",
         "TIER_REMOTE_POOL")


def _fields(x):
    return dataclasses.asdict(x)


def _cluster(mod, chip: str, n: int, tp: int):
    return mod.ClusterSpec(mod.CHIPS[chip], n, tp)


def test_hardware_equals_jax_field_for_field():
    assert list(hw.CHIPS) == list(jhw.CHIPS)
    for name in hw.CHIPS:
        assert _fields(hw.CHIPS[name]) == _fields(jhw.CHIPS[name])
    assert [_fields(l) for l in hw.LINKS.values()] == \
        [_fields(l) for l in jhw.LINKS.values()]
    for t in TIERS:
        assert _fields(getattr(hw, t)) == _fields(getattr(jhw, t))
        assert getattr(hw, t).transfer_time(1e6) == \
            getattr(jhw, t).transfer_time(1e6)
    assert [_fields(t) for t in hw.DEFAULT_SWAP_TIERS] == \
        [_fields(t) for t in jhw.DEFAULT_SWAP_TIERS]
    assert hw.H100 == hw.ChipSpec("H100", 989e12, 3.35e12, 80e9, 700.0)
    assert hw.NVLINK == hw.LinkSpec("NVLink", 450e9, 2e-6)
    for chip in hw.CHIPS:
        a, b = _cluster(hw, chip, 8, 4), _cluster(jhw, chip, 8, 4)
        assert (a.total_mem, a.total_flops, a.total_bw) == \
            (b.total_mem, b.total_flops, b.total_bw)
        assert _fields(a.intra_link) == _fields(b.intra_link)


@pytest.mark.parametrize("n,tp", [(1, 1), (4, 2), (16, 8)])
def test_rag_costs_equal_jax(n, tp):
    cfg, jcfg = rag.IVFPQConfig(), jrag.IVFPQConfig()
    assert _fields(cfg) == _fields(jcfg)
    small = dict(n_centroids=1000, n_probe=4, points_per_probe=100)
    for chip in ("H100", "GraceCPU"):
        for c, jc in ((cfg, jcfg), (rag.IVFPQConfig(**small),
                                    jrag.IVFPQConfig(**small))):
            for f in ("retrieval_time", "rerank_time"):
                got = getattr(rag, f)(c, _cluster(hw, chip, n, tp))
                want = getattr(jrag, f)(jc, _cluster(jhw, chip, n, tp))
                assert dataclasses.astuple(got) == dataclasses.astuple(want)


def _config_pairs():
    for arch in ARCH_IDS:
        yield arch, get_config(arch), jget_config(arch)
        yield arch + ".reduced", get_reduced_config(arch), jget_reduced(arch)


def _calls(mod, cfg, cluster, draft):
    """Every function of ``analytical`` on one config and cluster, its
    results as plain tuples."""
    st = dataclasses.astuple
    out = [mod.kv_bytes_per_token(cfg), mod.ssm_state_bytes(cfg),
           mod._tp_collective_time(cluster, 512, cfg.d_model,
                                   cfg.num_layers),
           mod.idle_stall_energy(0.25, cluster),
           st(mod.embedding_time(cfg, cluster, 96))]
    for ctx in (0, 1, 777, 32768):
        out.append(mod.flops_per_token(cfg, context=ctx))
    for toks, b, past in ((1, 1, 0), (300, 2, 1000), (4096, 8, 8192)):
        out.append(st(mod.prefill_time(cfg, cluster, toks, b,
                                       past_tokens=past)))
    for b, ctx in ((1, 1), (8, 2048), (128, 32768)):
        out.append(st(mod.decode_step_time(cfg, cluster, b, ctx)))
        out.append(st(mod.chunked_step_time(cfg, cluster, 256, b, ctx)))
    for k, alpha in ((4, 0.8), (3, 1.0), (5, (0.9, 0.7, 0.5))):
        out.append(mod.expected_accepted_tokens(k, alpha))
        cost, exp = mod.speculative_decode_step(cfg, draft, cluster, 4, 1024,
                                                k, alpha)
        out.append((st(cost), exp))
    return out


@pytest.mark.parametrize("n,tp", [(1, 1), (2, 1), (2, 2), (8, 1), (8, 8)])
def test_analytical_equals_jax_exactly(n, tp):
    """Plain Python on the same config fields: equal, not merely close,
    over every registered config (full and reduced) x chip count x tp."""
    draft, jdraft = get_config("guard_2b"), jget_config("guard_2b")
    for chip in ("H100", "A100", "TPUv5e"):
        cl, jcl = _cluster(hw, chip, n, tp), _cluster(jhw, chip, n, tp)
        for name, cfg, jcfg in _config_pairs():
            assert _calls(ana, cfg, cl, draft) == \
                _calls(jana, jcfg, jcl, jdraft), (name, chip)
        for tier, jtier in zip(hw.DEFAULT_SWAP_TIERS,
                               jhw.DEFAULT_SWAP_TIERS):
            assert dataclasses.astuple(ana.kv_swap_cost(3e8, tier, cl)) == \
                dataclasses.astuple(jana.kv_swap_cost(3e8, jtier, jcl))


# ---------------------------------------------------------------------------
# the ridge fits: XᵀX of features up to p² ~ 6.7e7 is badly conditioned in
# fp32, so two fp32 solvers give far-apart weights; their predictions are
# held instead, against float64's at the fit's own points.

# the torch fit's largest prediction error (relative to the largest
# float64 prediction) over JAX's own at the same points. Measured (torch
# 2.13 CPU, jax 0.9.0) over every registered config on H100 clusters of
# 1, 2 and 8 cards: at most 1.18x (decode) and 1.25x (prefill), median
# 0.35x; over 20 seeded random traces of 200 rows: at most 7.8x (decode)
# and 10.5x (prefill), median 3.1x and 2.3x (torch's fp32 XᵀX sums in
# another order than XLA's, and these points fill the features' range
# less evenly than the analytical grid). So 4x on the grid, 16x on traces
RIDGE_FACTOR = 4.0
TRACE_FACTOR = 16.0
# floor of JAX's own error, below which the two are equal to fp32 rounding
RIDGE_FLOOR = 1e-6
RIDGE_ARCHS = ("gemma_2b", "llama3_70b", "deepseek_v2_236b", "zamba2_7b",
               "xlstm_1_3b")


def _f64_fit(X, y):
    X, y = np.asarray(X, np.float64), np.asarray(y, np.float64)
    w = np.linalg.solve(X.T @ X + 1e-6 * np.eye(X.shape[1]), X.T @ y)
    return X @ w


def _rel(pred, want):
    return float(np.abs(np.asarray(pred, np.float64) - want).max()
                 / np.abs(want).max())


def _within_jax(kind, t, j, args, feats, y, factor=RIDGE_FACTOR):
    want = _f64_fit(feats, y)
    got = t.predict(*args).cpu().numpy()
    jerr = _rel(np.asarray(j.predict(*args)), want)
    assert _rel(got, want) <= factor * max(jerr, RIDGE_FLOOR), \
        (kind, _rel(got, want), jerr)
    # and the fitted models' own mse agrees to fp32 rounding of the times
    assert abs(t.mse - j.mse) <= 1e-3 * float(np.mean(np.square(y))) + 1e-12


@pytest.mark.parametrize("arch", RIDGE_ARCHS)
def test_ridge_fits_predict_within_jax_fp32_error(arch):
    cl, jcl = hw.ClusterSpec(hw.H100, 8, 8), jhw.ClusterSpec(jhw.H100, 8, 8)
    cfg, jcfg = get_config(arch), jget_config(arch)
    t = reg.fit_decode_model(cfg, cl, device="cpu")
    j = jreg.fit_decode_model(jcfg, jcl)
    assert t.weights.device.type == "cpu" and t.weights.dtype == torch.float32
    b = np.tile([1, 2, 4, 8, 16, 32, 64, 128], 6)
    p = np.repeat([128, 512, 1024, 2048, 4096, 8192], 8)
    y = [ana.decode_step_time(cfg, cl, int(x), int(c)).time
         for x, c in zip(b, p)]
    feats = np.stack([np.ones_like(b), b, p, b * p, b * b, p * p], -1)
    _within_jax("decode", t, j, (b, p), feats, y)
    batched = reg.batched_decode_predict(t, b, p)
    assert torch.equal(batched, t.predict(b, p))
    np.testing.assert_allclose(
        batched.numpy(), np.asarray(jreg.batched_decode_predict(j, b, p)),
        rtol=0, atol=RIDGE_FACTOR * max(_rel(np.asarray(j.predict(b, p)),
                                             _f64_fit(feats, y)), RIDGE_FLOOR)
        * max(y))

    t = reg.fit_prefill_model(cfg, cl, device="cpu")
    j = jreg.fit_prefill_model(jcfg, jcl)
    grid = np.array([(p_, n_, b_) for p_ in (0, 512, 2048, 8192)
                     for n_ in (64, 128, 256, 512, 1024, 2048, 4096)
                     for b_ in (1, 2, 4, 8)])
    pa, na, ba = grid.T
    y = [ana.prefill_time(cfg, cl, int(n_), int(b_), past_tokens=int(p_)).time
         for p_, n_, b_ in grid]
    feats = np.stack([np.ones_like(pa), pa, na, ba, na * na, pa * na,
                      ba * na], -1)
    _within_jax("prefill", t, j, (pa, na, ba), feats, y)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_fit_from_trace_within_jax_fp32_error(seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(1, 129, 200)
    p = rng.integers(64, 8193, 200)
    t_dec = 2e-3 + 1e-5 * b + 3e-9 * b * p + 0.02e-3 * rng.standard_normal(200)
    rows = np.stack([b, p, t_dec], -1)
    r32 = rows.astype(np.float32).astype(np.float64)
    t, j = reg.fit_from_trace(rows, "decode", "cpu"), jreg.fit_from_trace(rows)
    feats = np.stack([np.ones_like(b), b, p, b * p, b * b, p * p], -1)
    _within_jax("trace decode", t, j, (b, p), feats, r32[:, 2],
                TRACE_FACTOR)
    n = rng.integers(16, 4097, 200)
    bb = rng.integers(1, 9, 200)
    rows = np.stack([p, n, bb, 1e-3 + 2e-7 * n * bb / 8 + 1e-10 * p * n], -1)
    r32 = rows.astype(np.float32).astype(np.float64)
    t = reg.fit_from_trace(rows, "prefill", "cpu")
    j = jreg.fit_from_trace(rows, "prefill")
    feats = np.stack([np.ones(200), r32[:, 0], r32[:, 1], r32[:, 2],
                      r32[:, 1] ** 2, r32[:, 0] * r32[:, 1],
                      r32[:, 2] * r32[:, 1]], -1)
    _within_jax("trace prefill", t, j, tuple(rows[:, :3].T), feats,
                r32[:, 3], TRACE_FACTOR)


def test_ridge_fit_is_jax_on_a_well_conditioned_system():
    """Away from the polynomial features' conditioning the normal
    equations give JAX's weights to fp32 rounding."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((64, 5)).astype(np.float32)
    y = (X @ np.arange(1, 6, dtype=np.float32)
         + 0.01 * rng.standard_normal(64).astype(np.float32))
    got = reg.ridge_fit(torch.from_numpy(X), torch.from_numpy(y)).numpy()
    want = np.asarray(jreg.ridge_fit(jnp.asarray(X), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
