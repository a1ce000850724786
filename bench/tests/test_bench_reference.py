"""The plain references against the port at each family's ``reduced()``
config on the CPU, in fp32: every position's logits. The test imports
both; the references import nothing of the port."""
import pytest
import torch

from bench import weights
from bench.reference import gqa_dense, mla_moe
from bench.tests import small


@pytest.mark.parametrize("hf,ref", [(small.GQA, gqa_dense),
                                    (small.MLA, mla_moe)],
                         ids=["gqa_dense", "mla_moe"])
def test_reference_matches_port(hf, ref):
    from repro_torch.models import transformer
    cfg = small.port_cfg(hf)
    from bench import run
    run.check_port_config(small.port_cfg(hf), ref.port_fields(hf))
    params = weights.make(transformer.param_shapes(cfg), 11, "cpu",
                          dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, hf["vocab_size"], (n,), generator=gen)
            for n in (37, 64)]
    want = [list(range(len(s))) for s in seqs]
    got = ref.logits(hf, params, seqs, want)
    for s, g in zip(seqs, got):
        port, _ = transformer.train_forward(params, cfg, tokens=s[None])
        port = port[0].float()
        assert (g - port).abs().max() <= 1e-4 * port.abs().max()


def test_port_config_mismatch_refused():
    from bench import run
    hf = dict(small.GQA, hidden_size=128)
    with pytest.raises(ValueError):
        run.check_port_config(small.port_cfg(small.GQA),
                              gqa_dense.port_fields(hf))


def test_every_leaf_is_drawn():
    from repro_torch.models import transformer
    cfg = small.port_cfg(small.MLA)
    p = weights.make(transformer.param_shapes(cfg), 3, "cpu")
    # the cells' type

    def leaves(t):
        return [x for v in t.values() for x in
                (leaves(v) if isinstance(v, dict) else [v])]
    for t in leaves(p):
        assert t.dtype == torch.bfloat16 and t.float().std() > 0
    q = weights.make(transformer.param_shapes(cfg), 3, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(p), leaves(q)))
