"""PyTorch port, training on the CPU: the train step (``cross_entropy``,
AdamW and its schedule, autograd through the model), the data pipeline,
checkpoints and ``launch.train``, each held against the JAX package on the
same seeded numpy inputs and on weights carried by ``from_jax_params``:
``hubert_xlarge``'s config, ``batch_at``, ``lr_at``, ``adamw_update``,
``cross_entropy``, the plain attention backward against autograd and
``jax.vjp``, mode "train" logits (``gemma_2b``, ``pixtral_12b`` and
``hubert_xlarge`` from tokens and from embeds), three train steps of
reduced ``gemma_2b`` and ``hubert_xlarge`` from JAX's state, remat "full"
== "none", HuBERT's ``prefill_step``, checkpoints byte-identical to JAX's
and read by either package, the msgpack writer's size classes, a resumed
``launch.train`` run. The other families' training is held in
``test_torch_train_families.py``."""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_reduced_config as jreduced
from repro.configs import hubert_xlarge as jhubert
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro.models import optim as joptim
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_reduced_config, hubert_xlarge
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ref
from repro_torch.launch import train
from repro_torch.models import optim, steps
from repro_torch.models import transformer as ttf

FP32 = dict(param_dtype="float32", compute_dtype="float32")
# fp32 on both sides: same arithmetic, XLA and PyTorch sum in other orders
LOGITS_ATOL = 1e-4
STEP_RTOL = 1e-5
OPT_ATOL = 1e-6


def _configs(arch, **kw):
    return (jreduced(arch).replace(**FP32, **kw),
            get_reduced_config(arch).replace(**FP32, **kw))


def _perturbed(jcfg, seed):
    """JAX init + seeded numpy noise on every leaf (the JAX init zeroes the
    output projections and norm gammas), as numpy fp32 arrays."""
    p, _ = jtf.init_model(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.1
                   ).astype(np.float32), p)


def _np(t):
    return t.detach().float().numpy()


def _batch(cfg, seed, b=2, s=24, embeds=False):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if embeds:
        out["embeds"] = rng.standard_normal((b, s, cfg.frontend_dim)
                                            ).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)
                                     ).astype(np.int32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_hubert_config_and_reduced_equal_jax():
    assert dataclasses.asdict(hubert_xlarge.CONFIG) == dataclasses.asdict(
        jhubert.CONFIG)
    assert dataclasses.asdict(hubert_xlarge.reduced()) == dataclasses.asdict(
        jhubert.reduced())


@pytest.mark.parametrize("seed,step,n_hosts", [(0, 0, 1), (0, 7, 1),
                                               (3, 123, 2), (11, 5, 4)])
def test_batch_at_equals_jax(seed, step, n_hosts):
    for host in range(n_hosts):
        kw = dict(vocab_size=97, seq_len=33, global_batch=8, seed=seed,
                  host_id=host, n_hosts=n_hosts)
        got = tpipe.batch_at(tpipe.DataConfig(**kw), step)
        want = jpipe.batch_at(jpipe.DataConfig(**kw), step)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_lr_at_within_fp32_rounding_of_jax():
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    steps_ = np.arange(0, 121, dtype=np.int32)
    got = optim.lr_at(optim.OptConfig(**kw), torch.from_numpy(steps_))
    want = np.asarray(joptim.lr_at(joptim.OptConfig(**kw),
                                   jnp.asarray(steps_)))
    assert got.dtype == torch.float32
    # a couple of fp32 ulps of lr: near the cosine's end 1 + cos(pi t)
    # cancels, and an ulp of cos is ~1e-7 of lr there
    np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7,
                               atol=kw["lr"] * 2.0 ** -22)


def _tree(rng, dtype):
    return {"a": rng.standard_normal((4, 3)).astype(dtype),
            "b": {"c": rng.standard_normal(5).astype(dtype),
                  "d": rng.standard_normal((2, 2, 2)).astype(dtype)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.5, 1e9])
def test_adamw_update_matches_jax(dtype, clip):
    """Three AdamW steps on a seeded tree: params, m, v, step and the
    gradient norm; clip 0.5 clips every step, 1e9 none."""
    rng = np.random.default_rng(5)
    npdt = jnp.dtype(dtype)
    params = _tree(rng, npdt)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, params)
    jst = joptim.init_opt_state(jp)
    tp = weights.from_jax_params(params, "cpu")
    tst = optim.init_opt_state(tp)
    for _ in range(3):
        grads = _tree(rng, npdt)
        jp, jst, jg = joptim.adamw_update(
            jp, jax.tree.map(jnp.asarray, grads), jst,
            joptim.OptConfig(**kw))
        tp, tst, tg = optim.adamw_update(
            tp, weights.from_jax_params(grads, "cpu"), tst,
            optim.OptConfig(**kw))
        np.testing.assert_allclose(float(tg), float(jg), rtol=OPT_ATOL)
    assert int(tst["step"]) == int(jst["step"]) == 3
    assert tst["step"].dtype == torch.int32
    for got, want in ((tp, jp), (tst["m"], jst["m"]), (tst["v"], jst["v"])):
        for k, w in _flat(want).items():
            g = _flat(got)[k]
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                       atol=OPT_ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    got = steps.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    want = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("dq,dv", [(16, 16), (24, 16)])
def test_plain_attention_backward_matches_autograd_and_jax(causal, g, dq, dv):
    """``ref.flash_attention_bwd`` equals autograd of ``ref.flash_attention``
    (1e-6) and ``jax.vjp`` of the JAX reference (1e-5), fp32."""
    rng = np.random.default_rng(7)
    b, s, kvh = 2, 37, 2
    q = rng.standard_normal((b, s, kvh * g, dq)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, dq)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, dv)).astype(np.float32)
    do = rng.standard_normal((b, s, kvh * g, dv)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = ref.flash_attention(tq, tk, tv, causal=causal)
    o.backward(torch.from_numpy(do))
    _, lse = ref.flash_attention_lse(tq.detach(), tk.detach(), tv.detach(),
                                     causal=causal)
    got = ref.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                  o.detach(), lse, torch.from_numpy(do),
                                  causal)
    _, vjp = jax.vjp(functools.partial(jref.flash_attention, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    # of each gradient's largest entry (entries reach ~3: 1e-6 absolute
    # is a few fp32 ulps there)
    for x, gx, jx in zip((tq, tk, tv), got, jgrads):
        scale = float(x.grad.abs().max())
        np.testing.assert_allclose(_np(gx), _np(x.grad), atol=1e-6 * scale,
                                   rtol=0)
        np.testing.assert_allclose(_np(gx), np.asarray(jx),
                                   atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("arch,embeds", [("gemma_2b", False),
                                         ("pixtral_12b", True),
                                         ("hubert_xlarge", False),
                                         ("hubert_xlarge", True)])
def test_train_forward_logits_match_jax(arch, embeds):
    jcfg, tcfg = _configs(arch)
    pn = _perturbed(jcfg, seed=8)
    batch = _batch(tcfg, 9, embeds=embeds)
    key = "embeds" if embeds else "tokens"
    want, _, _ = jtf.forward(jax.tree.map(jnp.asarray, pn), jcfg,
                             mode="train", **{key: jnp.asarray(batch[key])})
    got, caches = ttf.forward(weights.from_jax_params(pn, "cpu"), tcfg,
                              mode="train",
                              **{key: torch.from_numpy(batch[key])})
    assert caches is None and got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGITS_ATOL,
                               rtol=0)


def _close_to_max(got, want, rtol, what):
    """Every leaf of ``want`` within ``rtol`` of its largest entry."""
    got = _flat(got)
    for k, w in _flat(want).items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(_np(got[k]), w, rtol=0,
                                   atol=rtol * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


def _params_close(got, want, before, v, what):
    """New params within STEP_RTOL of each leaf's largest entry, except at
    entries whose gradients so far are at fp32 noise (sqrt v below 1e-5
    of the leaf's largest): there AdamW's normalised step follows the
    noise's sign, and the two may part by up to twice the step that JAX
    took there (its step one way, the port's the other)."""
    got, before, v = _flat(got), _flat(before), _flat(v)
    for k, w in _flat(want).items():
        w = np.asarray(w, np.float32)
        err = np.abs(_np(got[k]) - w)
        jax_step = np.abs(w - np.asarray(before[k], np.float32))
        sv = np.sqrt(np.asarray(v[k]))
        noise = sv < 1e-5 * sv.max()
        assert noise.mean() < 1e-2, (what, k, noise.mean())
        assert (err[~noise] <= STEP_RTOL * np.abs(w).max()).all(), (
            what, k, float(err[~noise].max()))
        assert (err[noise] <= 2 * jax_step[noise]).all(), (what, k)


@pytest.mark.parametrize("arch", ["gemma_2b", "hubert_xlarge"])
def test_train_steps_match_jax(arch):
    """Three train steps from JAX's state carried across: each package runs
    its own chain, and the loss and grad norm agree at each step. The
    params, m and v after each step are held from the state before it
    carried across (``_params_close``): AdamW's normalised update turns
    the fp32 noise of a gradient near 0 into a step of order lr at that
    entry, so two chains part by more than 1e-5 at a few entries by their
    third step (5.9e-4 at one entry of gemma's wo)."""
    jcfg, tcfg = _configs(arch)
    pn = _perturbed(jcfg, seed=10)
    jstate = {"params": jax.tree.map(jnp.asarray, pn),
              "opt": joptim.init_opt_state(pn)}
    tstate = weights.from_jax_params(
        jax.tree.map(np.asarray, jstate), "cpu")
    assert tstate["opt"]["step"].dtype == torch.int32
    opt = optim.OptConfig(lr=3e-3, warmup_steps=2, total_steps=3)
    jstep = jax.jit(lambda st, b: jsteps.train_step(
        st, b, jcfg, joptim.OptConfig(**dataclasses.asdict(opt))))
    for i in range(3):
        batch = _batch(tcfg, 20 + i, embeds=tcfg.stub_frontend)
        before = weights.from_jax_params(jax.tree.map(np.asarray, jstate),
                                         "cpu")
        jparams = jstate["params"]
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = steps.train_step(tstate, _torch_batch(batch), tcfg, opt)
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=STEP_RTOL)
        assert float(tm["aux_loss"]) == 0.0
        one, _ = steps.train_step(before, _torch_batch(batch), tcfg, opt)
        assert int(one["opt"]["step"]) == int(jstate["opt"]["step"]) == i + 1
        _params_close(one["params"], jstate["params"], jparams,
                      jstate["opt"]["v"], "params")
        _close_to_max(one["opt"]["m"], jstate["opt"]["m"], STEP_RTOL, "m")
        _close_to_max(one["opt"]["v"], jstate["opt"]["v"], STEP_RTOL, "v")


def test_remat_full_equals_none_bitwise_on_cpu():
    _, tcfg = _configs("gemma_2b")
    params = ttf.init_model(tcfg, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():
        for t in _flat(params).values():
            t.add_(torch.randn(t.shape, generator=torch.Generator()
                               .manual_seed(t.numel())) * 0.1)
    batch = _torch_batch(_batch(tcfg, 11))
    out = {}
    for remat in ("full", "none"):
        (total, _), grads = steps.value_and_grad(
            params, batch, tcfg.replace(remat=remat))
        out[remat] = (total, _flat(grads))
    assert torch.equal(out["full"][0], out["none"][0])
    for k, g in out["full"][1].items():
        assert torch.equal(g, out["none"][1][k]), k


def test_hubert_prefill_step_matches_jax():
    """HuBERT's serving entry: the encoder forward over embeds, logits at
    every position, no caches."""
    jcfg, tcfg = _configs("hubert_xlarge")
    pn = _perturbed(jcfg, seed=12)
    batch = _batch(tcfg, 13, embeds=True)
    want, jc = jsteps.prefill_step(jax.tree.map(jnp.asarray, pn),
                                   {"embeds": jnp.asarray(batch["embeds"])},
                                   jcfg, max_len=64)
    got, tc = steps.prefill_step(weights.from_jax_params(pn, "cpu"),
                                 {"embeds": torch.from_numpy(batch["embeds"])},
                                 tcfg, max_len=64)
    assert jc is None and tc is None and got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGITS_ATOL,
                               rtol=0)


def _jax_train_state(param_dtype):
    cfg = jreduced("gemma_2b").replace(param_dtype=param_dtype,
                                       compute_dtype=param_dtype)
    st = jsteps.init_train_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(14)
    # m, v and the step away from their zeros
    st["opt"] = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        if a.ndim else jnp.asarray(17, a.dtype), st["opt"])
    return st


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_checkpoint_bytes_equal_jax_and_each_reads_the_other(tmp_path,
                                                             param_dtype):
    jst = _jax_train_state(param_dtype)
    tst = weights.from_jax_params(jax.tree.map(np.asarray, jst), "cpu")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jdir, 3, jst, extra={"note": "x"})
    ckpt.save(tdir, 3, tst, extra={"note": "x"})
    jfile = os.path.join(jdir, "step_00000003")
    tfile = os.path.join(tdir, "step_00000003")
    with open(os.path.join(jfile, "arrays.msgpack"), "rb") as f:
        jbytes = f.read()
    with open(os.path.join(tfile, "arrays.msgpack"), "rb") as f:
        assert f.read() == jbytes
    with open(os.path.join(jfile, "MANIFEST.json")) as f:
        jman = f.read()
    with open(os.path.join(tfile, "MANIFEST.json")) as f:
        assert f.read() == jman
    got, man = ckpt.restore(jdir, tst)
    assert man == json.loads(jman) and man["step"] == 3
    for k, v in _flat(tst).items():
        g = _flat(got)[k]
        assert g.dtype == v.dtype and torch.equal(g, v), k
    back, _ = jckpt.restore(tdir, jst)
    for a, b in zip(jax.tree.leaves(jst), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_checkpoint_latest_keep_and_tmp_dirs(tmp_path):
    t = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
         "b": {"c": torch.ones(2, 2, dtype=torch.bfloat16),
               "d": torch.tensor(7, dtype=torch.int32)}}
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, t, keep=2)
    assert ckpt.latest_step(d) == 5
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == [
        "step_00000004", "step_00000005"]
    os.makedirs(os.path.join(d, ".tmp_partial"))          # a crashed save
    os.makedirs(os.path.join(d, "step_00000009"))         # no manifest
    assert ckpt.latest_step(d) == 5
    got, man = ckpt.restore(d, t)
    assert man["step"] == 5 and torch.equal(got["b"]["c"], t["b"]["c"])
    with pytest.raises(KeyError):
        ckpt.restore(d, {**t, "e": torch.zeros(1)})


@pytest.mark.parametrize("obj", [
    "", "a" * 31, "a" * 32, "é" * 200, "a" * 255, "a" * 256, "a" * 65536,
    b"", b"x" * 255, b"x" * 256, b"x" * 65535, b"x" * 65536,
    [], list(range(15)), list(range(16)), list(range(65536)),
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"dtype": "bfloat16", "shape": [2, 3], "data": b"\x00\x01" * 6},
], ids=lambda o: f"{type(o).__name__}{len(o) if hasattr(o, '__len__') else o}")
def test_msgpack_subset_matches_packb(obj):
    want = msgpack.packb(obj)
    assert ckpt.packb(obj) == want
    back = ckpt.unpackb(want)
    if isinstance(obj, bytes):
        back = bytes(back)
    assert back == msgpack.unpackb(want)


def test_launch_train_resumes_to_the_uninterrupted_losses(tmp_path,
                                                        monkeypatch):
    args = ["--reduced", "--device", "cpu", "--steps", "10", "--batch", "4",
            "--seq", "32", "--log-every", "100"]
    whole = train.main(args)
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]

    class Stop(Exception):
        pass
    calls = []

    def stop_at_7(*a, **kw):                        # after step 6's save
        calls.append(1)
        if len(calls) == 7:
            raise Stop
        return real(*a, **kw)
    real = steps.train_step
    with monkeypatch.context() as m:
        m.setattr(steps, "train_step", stop_at_7)
        with pytest.raises(Stop):
            train.main(args + ck)
    assert ckpt.latest_step(str(tmp_path)) == 6
    resumed = train.main(args + ck)
    assert len(whole) == 10 and resumed == whole[6:]
