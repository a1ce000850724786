"""PyTorch port, training for MLA, MoE and the recurrent families on the
CPU: ``minicpm3_4b`` (dense, MLA), ``deepseek_v2_lite_16b`` and
``deepseek_v2_236b`` (MoE, MLA), ``zamba2_7b`` (hybrid) and ``xlstm_1_3b``
(ssm), reduced, fp32, held against the JAX package on the same seeded
numpy inputs and on weights carried by ``from_jax_params``: train-mode
logits and the routers' aux, three carried train steps (loss, aux and
grad norm; params, m and v one step from JAX's state), ``apply_moe``'s
gradient against ``jax.grad`` (also with rows dropped past capacity),
``torch._grouped_mm``'s backward given an expanded gradient, remat
"none", "full" and "dots" bitwise equal, "dots" saving the products,
AdamW's slices, ``check_train`` and ``launch.train``'s memory reckoning,
``launch.train`` resuming to the uninterrupted losses, checkpoints of the
MoE and ssm trees byte-identical to JAX's, and the ``examples`` twin of
``train_ft.py``."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import ckpt as jckpt
from repro.models import moe as jmoe
from repro.models import optim as joptim
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import tree, weights
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.launch import train
from repro_torch.models import moe as tmoe
from repro_torch.models import optim, steps
from repro_torch.models import transformer as ttf

from test_torch_train import (FP32, LOGITS_ATOL, STEP_RTOL, _close_to_max,
                              _configs, _flat, _np, _perturbed, _torch_batch)

FAMILIES = ("minicpm3_4b", "deepseek_v2_lite_16b", "deepseek_v2_236b",
            "zamba2_7b", "xlstm_1_3b")
MOE = ("deepseek_v2_lite_16b", "deepseek_v2_236b")
# the aux: fp32 sums of the same products, in other orders
AUX_RTOL = 1e-6
# apply_moe's gradient, fp32, of each leaf's largest entry (the router's
# reach ~800 under sum(y ** 2))
MOE_GRAD_RTOL = 1e-5
# zamba2's and xlstm's fp32 gradients are ill-conditioned at the test
# weights: JAX's own is 6.1e-6 and 5.7e-5 (largest leaf's relative norm)
# from its float64 gradient, against 1.0-1.7e-6 for MLA and MoE, and the
# port's as far (test_fp32_gradients_as_close_to_float64_as_jax, which
# also checks that JAX's own error is at least this factor x 1e-6). Their
# steps' grad norm, m and v are held within STEP_RTOL x the factor
FP32_COND = {"zamba2_7b": 5, "xlstm_1_3b": 20}
ROOT = Path(__file__).resolve().parents[1]


def _batch(cfg, seed, b=2, s=None):
    """Tokens and labels; 64 tokens for the recurrent families (two chunks
    of the reduced configs' 32-token scan), 24 otherwise."""
    s = s or (64 if ttf.prefill_chunk(cfg) else 24)
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _torch_params(tcfg, seed):
    """Seeded perturbed port weights (no JAX), for the port-only tests."""
    params = ttf.init_model(tcfg, torch.Generator().manual_seed(seed), "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for t in tree.leaves(params):
            t.add_(torch.randn(t.shape, generator=gen) * 0.1)
    return params


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_forward_logits_and_aux_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    pn = _perturbed(jcfg, seed=30)
    toks = _batch(tcfg, 31)["tokens"]
    want, _, jaux = jax.jit(lambda p, t: jtf.forward(
        p, jcfg, mode="train", tokens=t))(jax.tree.map(jnp.asarray, pn),
                                          jnp.asarray(toks))
    got, aux = ttf.train_forward(weights.from_jax_params(pn, "cpu"), tcfg,
                                 tokens=torch.from_numpy(toks))
    assert got.shape == want.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGITS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL,
                               atol=0)
    assert (float(aux) > 0) == (arch in MOE)
    logits, caches = ttf.forward(weights.from_jax_params(pn, "cpu"), tcfg,
                                 tokens=torch.from_numpy(toks), mode="train")
    assert caches is None and torch.equal(logits, got)


def _params_close(got, want, step, opt, what):
    """New params (``got`` and ``want``: the port's and JAX's states after
    one step from the same state) within STEP_RTOL of each leaf's largest
    entry, plus what the two states' differences in m and v make through
    AdamW's normalised step ``lr · m̂ / (√v̂ + eps)`` (first-order
    propagation, doubled). Where a gradient is at fp32 noise, v̂ is tiny and
    the step follows the noise's sign: an sLSTM forget-gate bias at
    saturation (a quarter of xlstm's ``slstm/b``) has only such gradients.
    The moments themselves are held within STEP_RTOL (``_close_to_max``)."""
    lr = float(optim.lr_at(opt, step))
    c1, c2 = 1 - opt.b1 ** step, 1 - opt.b2 ** step
    flat = {k: _flat(t) for k, t in (
        ("p", got["params"]), ("m", got["opt"]["m"]),
        ("v", got["opt"]["v"]))}
    for k, w in _flat(want["params"]).items():
        w = np.asarray(w, np.float32)
        m = np.asarray(_flat(want["opt"]["m"])[k], np.float64) / c1
        v = np.asarray(_flat(want["opt"]["v"])[k], np.float64) / c2
        dm = np.abs(_np(flat["m"][k]) / c1 - m)
        dv = np.abs(_np(flat["v"][k]) / c2 - v)
        s = np.sqrt(v)
        slack = lr * (dm / (s + opt.eps) + np.abs(m) * dv / (
            2 * np.maximum(s, 1e-30) * (s + opt.eps) ** 2))
        err = np.abs(_np(flat["p"][k]) - w)
        bad = err > STEP_RTOL * np.abs(w).max() + 2 * slack
        assert not bad.any(), (what, k, int(bad.sum()), float(err.max()))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_jax(arch):
    """Three train steps of JAX's, the port's each from JAX's state before
    it carried across: loss and aux_loss within STEP_RTOL, grad norm, m
    and v within STEP_RTOL x FP32_COND for the recurrent families; params,
    m and v held as
    ``test_torch_train.test_train_steps_match_jax`` holds them, the params
    by ``_params_close``. The port's own chain is not compared: xlstm's
    parts from JAX's by 2.2e-4 in loss at the third step, AdamW turning its
    gradients' fp32 noise into steps of order lr."""
    jcfg, tcfg = _configs(arch)
    pn = _perturbed(jcfg, seed=32)
    jstate = {"params": jax.tree.map(jnp.asarray, pn),
              "opt": joptim.init_opt_state(pn)}
    opt = optim.OptConfig(lr=3e-3, warmup_steps=2, total_steps=3)
    jstep = jax.jit(lambda st, b: jsteps.train_step(
        st, b, jcfg, joptim.OptConfig(**dataclasses.asdict(opt))))
    for i in range(3):
        batch = _batch(tcfg, 33 + i)
        before = weights.from_jax_params(jax.tree.map(np.asarray, jstate),
                                         "cpu")
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        one, tm = steps.train_step(before, _torch_batch(batch), tcfg, opt)
        cond = STEP_RTOL * FP32_COND.get(arch, 1)
        for name, rtol in (("loss", STEP_RTOL), ("aux_loss", STEP_RTOL),
                           ("grad_norm", cond)):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=rtol, err_msg=name)
        assert (float(tm["aux_loss"]) > 0) == (arch in MOE)
        assert int(one["opt"]["step"]) == int(jstate["opt"]["step"]) == i + 1
        _params_close(one, jstate, i + 1, opt, "params")
        _close_to_max(one["opt"]["m"], jstate["opt"]["m"], cond, "m")
        _close_to_max(one["opt"]["v"], jstate["opt"]["v"], cond, "v")


@pytest.mark.parametrize("arch", ["minicpm3_4b", "zamba2_7b", "xlstm_1_3b"])
def test_fp32_gradients_as_close_to_float64_as_jax(arch):
    """The port's fp32 gradient of one batch no further from JAX's float64
    gradient (``jax.enable_x64``) than twice JAX's own fp32 gradient is,
    plus 1e-6: each leaf's relative norm error within twice the largest of
    JAX's leaves', the whole gradient's within twice JAX's, for MLA and the
    two recurrent families (MoE's steps hold at STEP_RTOL). Measured (the
    largest leaf's): 1-2e-6 for MLA and MoE, 6-9e-6 for zamba2, 6-7e-5 for
    xlstm, both packages;
    for the families in FP32_COND, JAX's own error is at least its factor
    x 1e-6 (what widens their step test's tolerance)."""
    jcfg, tcfg = _configs(arch)
    pn = _perturbed(jcfg, seed=32)
    batch = _batch(tcfg, 33)

    def jgrad(cfg, dtype):
        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), pn)
        b = jax.tree.map(jnp.asarray, batch)
        g = jax.jit(jax.grad(lambda p: jsteps.loss_fn(p, b, cfg)[0]))(p)
        return {k: np.asarray(v, np.float64)
                for k, v in tree.flatten(jax.tree.map(np.asarray, g)).items()}
    j32 = jgrad(jcfg, jnp.float32)
    with jax.enable_x64(True):
        j64 = jgrad(jcfg.replace(param_dtype="float64",
                                 compute_dtype="float64",
                                 logits_dtype="float64"), jnp.float64)
    _, grads = steps.value_and_grad(weights.from_jax_params(pn, "cpu"),
                                    _torch_batch(batch), tcfg)
    t32 = {k: v.double().numpy() for k, v in tree.flatten(grads).items()}
    assert t32.keys() == j64.keys()

    def rel(g, k):
        return np.linalg.norm(g[k] - j64[k]) / np.linalg.norm(j64[k])
    own = max(rel(j32, k) for k in j64)
    assert own >= FP32_COND.get(arch, 0) * 1e-6, own
    for k in j64:
        assert rel(t32, k) <= 2 * own + 1e-6, (k, rel(t32, k), own)

    def whole(g):
        return np.sqrt(sum(((g[k] - j64[k]) ** 2).sum() for k in j64)
                       / sum((x ** 2).sum() for x in j64.values()))
    assert whole(t32) <= 2 * whole(j32) + 1e-6


@pytest.mark.parametrize("impl", ["ragged_ep", "dispatch_einsum"])
@pytest.mark.parametrize("slack", [2.0, 0.5])
def test_apply_moe_grad_matches_jax(impl, slack):
    """``jax.grad`` of JAX's ``test_moe_grads_finite`` loss, sum(y ** 2) +
    aux, against autograd of the port's, for the weights and the input; at
    slack 0.5 rows drop past each expert's capacity (zero gradient)."""
    jcfg, tcfg = _configs("deepseek_v2_lite_16b")
    moe = dict(capacity_slack=slack, impl=impl)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe))
    layers = _perturbed(jcfg, seed=34)["layers"]
    pn = jax.tree.map(lambda a: a[0], layers["moe"])
    x = np.random.default_rng(35).standard_normal(
        (2, 8, jcfg.d_model)).astype(np.float32)
    if impl == "ragged_ep" and slack < 1:
        assert tmoe._capacity(16, 2, 8, 8, slack) < 16 * 2   # rows drop

    def jloss(p, x):
        y, aux = jmoe.apply_moe(p, x, jcfg, mesh=None)
        return jnp.sum(y ** 2) + aux
    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, pn), jnp.asarray(x))
    tp = tree.map_tree(lambda t: t.requires_grad_(True),
                       weights.from_jax_params(pn, "cpu"))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.apply_moe(tp, tx, tcfg)
    (torch.sum(y ** 2) + aux).backward()
    _close_to_max(tree.map_tree(lambda t: t.grad, tp), want[0],
                  MOE_GRAD_RTOL, "grad")
    _close_to_max({"x": tx.grad}, {"x": want[1]}, MOE_GRAD_RTOL, "grad")


def test_grouped_mm_backward_takes_an_expanded_gradient():
    """``moe.ragged_dot`` under ``y.sum().backward()`` (a stride-0
    gradient, on which ``torch._grouped_mm``'s own backward raises): the
    per-group products' gradients, an empty group's zero."""
    gen = torch.Generator().manual_seed(36)
    x = torch.randn(12, 8, generator=gen).requires_grad_(True)
    w = torch.randn(4, 8, 16, generator=gen).requires_grad_(True)
    sizes = torch.tensor([5, 0, 4, 3])
    tmoe.ragged_dot(x, w, sizes).sum().backward()
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    lo = 0
    for g, n in enumerate(sizes.tolist()):
        (xr[lo:lo + n] @ wr[g]).sum().backward()
        lo += n
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(w.grad, wr.grad, rtol=1e-6, atol=1e-6)
    assert not w.grad[1].any()


@pytest.mark.parametrize("arch", ["minicpm3_4b", "deepseek_v2_lite_16b",
                                  "zamba2_7b", "xlstm_1_3b"])
def test_remat_gradients_equal_bitwise(arch):
    """One batch's loss, aux and gradients under remat "none", "full" and
    "dots": ``torch.equal``."""
    tcfg = get_reduced_config(arch).replace(**FP32)
    params = _torch_params(tcfg, 37)
    batch = _torch_batch(_batch(tcfg, 38))
    out = {}
    for remat in ttf.REMATS:
        (total, (_, aux)), grads = steps.value_and_grad(
            params, batch, tcfg.replace(remat=remat))
        out[remat] = (total, aux, tree.flatten(grads))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert torch.equal(out[remat][1], out["none"][1]), remat
        for k, g in out["none"][2].items():
            assert torch.equal(out[remat][2][k], g), (remat, k)


class _Products(TorchDispatchMode):
    """Counts the matrix products run while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in ttf._DOTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["gemma_2b", "deepseek_v2_lite_16b",
                                  "xlstm_1_3b"])
def test_remat_dots_recomputes_no_product(arch):
    """The backward runs as many matrix products under "dots" as under
    "none" (every forward product saved) and more under "full" (they are
    recomputed), as JAX's dots_saveable and nothing_saveable."""
    tcfg = get_reduced_config(arch).replace(**FP32)
    params = _torch_params(tcfg, 39)
    batch = _torch_batch(_batch(tcfg, 40))
    n = {}
    for remat in ttf.REMATS:
        live = tree.map_tree(lambda t: t.detach().requires_grad_(True),
                             params)
        total, _ = steps.loss_fn(live, batch, tcfg.replace(remat=remat))
        with _Products() as count:
            torch.autograd.grad(total, tree.leaves(live), allow_unused=True)
        n[remat] = count.n
    assert n["dots"] == n["none"] < n["full"], n


def test_adamw_slices_equal_whole_leaves(monkeypatch):
    """AdamW walked in slices of a leaf gives the whole leaf's update bit
    for bit (fp32 and bf16 leaves, 0-d, a row larger than a slice), and
    the global norm summed in slices the whole leaves' within fp32
    rounding."""
    gen = torch.Generator().manual_seed(41)

    def make():
        return {"a": torch.randn(5, 3, 2, generator=gen),
                "b": torch.randn(4, generator=gen),
                "c": torch.randn(3, 9, generator=gen).bfloat16(),
                "d": torch.randn((), generator=gen)}
    params, grads = make(), make()
    whole = tree.map_tree(torch.clone, params)
    st, st_whole = optim.init_opt_state(params), optim.init_opt_state(whole)
    opt = optim.OptConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    for _ in range(2):
        monkeypatch.setattr(optim, "SLICE_ELEMS", 7)
        *_, norm = optim.adamw_update(params, grads, st, opt)
        monkeypatch.setattr(optim, "SLICE_ELEMS", 1 << 25)
        *_, norm_whole = optim.adamw_update(whole, grads, st_whole, opt)
        torch.testing.assert_close(norm, norm_whole, rtol=1e-6, atol=0)
    for got, want in ((params, whole), (st["m"], st_whole["m"]),
                      (st["v"], st_whole["v"])):
        for k, w in tree.flatten(want).items():
            assert torch.equal(tree.flatten(got)[k], w), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_check_train_admits_every_config(arch):
    for remat in ttf.REMATS:
        ttf.check_train(get_config(arch).replace(remat=remat))
        ttf.check_train(get_reduced_config(arch).replace(remat=remat))


def test_check_train_refuses_an_unknown_remat_and_a_gqa_moe():
    with pytest.raises(ValueError, match="remat"):
        ttf.check_train(get_reduced_config("gemma_2b").replace(
            remat="offload"))
    cfg = get_reduced_config("deepseek_v2_lite_16b")
    with pytest.raises(NotImplementedError, match="GQA MoE|gqa"):
        ttf.check_train(cfg.replace(attn_type="gqa"))


def test_launch_train_reckons_the_state_against_the_card():
    """deepseek_v2_236b whole: 235.74B parameters x 12 B of bf16 state is
    more than an 80 GB card; v2-lite at 5 layers fits."""
    big = get_config("deepseek_v2_236b").replace(param_dtype="bfloat16")
    with pytest.raises(ValueError, match=r"235\.74B parameters x 12 B"):
        train.check_fits(big, 80 * 10 ** 9)
    lite = get_config("deepseek_v2_lite_16b").replace(
        param_dtype="bfloat16", num_layers=5)
    train.check_fits(lite, 80 * 10 ** 9)
    assert train.param_count(big) == 235_741_434_880


@pytest.mark.parametrize("arch", ["minicpm3_4b", "zamba2_7b", "xlstm_1_3b"])
def test_launch_train_runs_each_family(arch):
    losses = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "32",
                         "--log-every", "100"])
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_launch_train_resumes_moe_to_the_uninterrupted_losses(tmp_path,
                                                            monkeypatch):
    args = ["--arch", "deepseek_v2_lite_16b", "--reduced", "--device",
            "cpu", "--steps", "6", "--batch", "4", "--seq", "32",
            "--log-every", "100"]
    whole = train.main(args)
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]

    class Stop(Exception):
        pass
    calls = []
    real = steps.train_step

    def stop_at_5(*a, **kw):                        # after step 4's save
        calls.append(1)
        if len(calls) == 5:
            raise Stop
        return real(*a, **kw)
    with monkeypatch.context() as m:
        m.setattr(steps, "train_step", stop_at_5)
        with pytest.raises(Stop):
            train.main(args + ck)
    assert ckpt.latest_step(str(tmp_path)) == 4
    resumed = train.main(args + ck)
    assert len(whole) == 6 and resumed == whole[4:]


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "xlstm_1_3b"])
def test_checkpoint_bytes_equal_jax(tmp_path, arch):
    """A whole train state of the MoE and the ssm tree, moments and step
    away from zero, written by both packages: the same bytes."""
    jcfg = _configs(arch)[0].replace(param_dtype="bfloat16",
                                     compute_dtype="bfloat16")
    jst = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(42)
    jst["opt"] = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        if a.ndim else jnp.asarray(5, a.dtype), jst["opt"])
    tst = weights.from_jax_params(jax.tree.map(np.asarray, jst), "cpu")
    jckpt.save(str(tmp_path / "jax"), 5, jst)
    ckpt.save(str(tmp_path / "torch"), 5, tst)
    for name in ("arrays.msgpack", "MANIFEST.json"):
        files = [tmp_path / side / "step_00000005" / name
                 for side in ("jax", "torch")]
        assert files[0].read_bytes() == files[1].read_bytes(), name
    got, man = ckpt.restore(str(tmp_path / "jax"), tst)
    assert man["step"] == 5
    for k, v in tree.flatten(tst).items():
        assert torch.equal(tree.flatten(got)[k], v), k


def test_train_ft_twin_runs_at_its_smallest():
    spec = importlib.util.spec_from_file_location(
        "train_ft_torch", ROOT / "examples" / "train_ft_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    first, second = mod.main(["--device", "cpu", "--steps", "4", "--more",
                              "2", "--every", "2", "--batch", "2", "--seq",
                              "16"])
    assert len(first) == 4 and len(second) == 2


def _large_gate_weights(tcfg, share=3.0):
    """Seeded port weights with every leaf perturbed by ``share`` x its
    fan-in scale: large gate pre-activations, some mLSTM stabiliser below
    -88.7, so that exp(-m) overflows to inf."""
    gen = torch.Generator().manual_seed(43)
    params = ttf.init_model(tcfg, gen, "cpu")
    with torch.no_grad():
        for t in tree.leaves(params):
            fan = t.shape[1] if t.ndim >= 2 else t.shape[0]
            t.add_(torch.randn(t.shape, generator=gen) * share * fan ** -0.5)
    return params


def test_mlstm_gradient_is_finite_where_jax_is_nan():
    """Where the chunked mLSTM's floor exp(-m) overflows, JAX's gradient is
    NaN in every leaf the layers reach (all but the head and the final
    norm) and the port's is finite (``xlstm._exp_floor``: 0 there, the
    output being 0 whatever m is); the loss is JAX's (within xlstm's fp32
    conditioning, FP32_COND)."""
    jcfg, tcfg = _configs("xlstm_1_3b", remat="none")
    params = _large_gate_weights(tcfg)
    batch = _batch(tcfg, 44)
    (total, _), grads = steps.value_and_grad(params, _torch_batch(batch),
                                             tcfg)
    assert all(torch.isfinite(g).all() for g in tree.leaves(grads))
    jp = jax.tree.map(jnp.asarray, tree.map_tree(
        lambda t: t.numpy(), params))
    jb = jax.tree.map(jnp.asarray, batch)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jb, jcfg), has_aux=True))(jp)
    nan = {k for k, g in tree.flatten(jax.tree.map(np.asarray, jgrads)
                                      ).items() if np.isnan(g).any()}
    assert nan == set(tree.flatten(grads)) - {"head", "final_norm/gamma"}
    np.testing.assert_allclose(float(total), float(jtotal),
                               rtol=STEP_RTOL * FP32_COND["xlstm_1_3b"])


def test_mlstm_floor_gradient_is_autograds_where_finite(monkeypatch):
    """Where exp(-m) does not overflow, the floor's gradient is autograd's
    of plain exp bit for bit."""
    from repro_torch.models import xlstm as txl
    tcfg = get_reduced_config("xlstm_1_3b").replace(**FP32)
    params = _torch_params(tcfg, 45)
    batch = _torch_batch(_batch(tcfg, 46))
    _, ours = steps.value_and_grad(params, batch, tcfg)
    monkeypatch.setattr(txl, "_exp_floor", lambda m: torch.exp(-m))
    _, plain = steps.value_and_grad(params, batch, tcfg)
    for k, g in tree.flatten(plain).items():
        assert torch.isfinite(g).all() and torch.equal(
            tree.flatten(ours)[k], g), k
