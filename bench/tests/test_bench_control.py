"""``correct`` against its control and the faults a served cell can have,
at the test size on the CPU: the harness's run with the chip check
skipped and the timed path broken underneath must read ``correct``
false; the fp8 control must read above the limit that sound runs keep
under. (On the card the same comparisons read at the cells' own sizes:
``python3 bench/calibrate.py``.)"""
import pytest
import torch

from bench import calibrate, run
from bench.tests import small

FAMILIES = [small.GQA, small.MLA]
IDS = ["gqa_dense", "mla_moe"]


def _run(hf, seed=5):
    return run.run_cell(small.cell(hf), seed, small.SECONDS, False,
                        device="cpu",
                        port_cfg=small.port_cfg(hf))


@pytest.mark.parametrize("hf", FAMILIES, ids=IDS)
def test_sound_run_is_correct(hf):
    out = _run(hf)
    assert out["correct"], out
    assert list(out)[-1] == "checks"


def _token_altered(monkeypatch, vocab):
    from repro_torch.engine import graphs
    orig = graphs.CompiledPass.run

    def run_(self, **arrays):
        tok, logits = orig(self, **arrays)
        return (tok + 1) % vocab, logits
    monkeypatch.setattr(graphs.CompiledPass, "run", run_)


def _half_batch(monkeypatch, vocab):
    from repro_torch.engine import graphs
    orig = graphs.CompiledPass.run

    def run_(self, **arrays):
        tok, logits = orig(self, **arrays)
        tok = tok.clone()
        half = tok.shape[0] // 2
        tok[half:] = torch.as_tensor(arrays["tokens"][half:, 0])
        return tok, logits
    monkeypatch.setattr(graphs.CompiledPass, "run", run_)


def _state_unchanged(monkeypatch, vocab):
    from repro_torch.models import steps
    orig = steps.serve_step

    def serve_step(params, tokens, caches, cfg, *a, **k):
        kept = [(t, t.clone()) for g in caches.values() for n, t in g.items()
                if isinstance(t, torch.Tensor) and n != "length"
                and t.is_contiguous()]
        out = orig(params, tokens, caches, cfg, *a, **k)
        for t, c in kept:
            t.copy_(c)
        return out
    monkeypatch.setattr(steps, "serve_step", serve_step)


@pytest.mark.parametrize("fault", [_token_altered, _half_batch,
                                   _state_unchanged],
                         ids=["token_altered", "half_batch",
                              "state_unchanged"])
@pytest.mark.parametrize("hf", FAMILIES, ids=IDS)
def test_fault_reads_incorrect(hf, fault, monkeypatch):
    fault(monkeypatch, hf["vocab_size"])
    out = _run(hf)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("hf", FAMILIES, ids=IDS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_fails_the_limit(hf, seed):
    """``calibrate.control``, as run on the card: the program's sample
    reads correct at the limits, the fp8 control's not."""
    got, = calibrate.control(small.cell(hf), [seed], small.SECONDS,
                             device="cpu", port_cfg=small.port_cfg(hf))
    assert got["program_correct"], got["program_checks"]
    assert not got["control_correct"], got["control_checks"]
    for name, limit in hf["limits"].items():
        key = {"gap": "max", "mean_gap": "mean"}[name]
        assert got["program"][key] <= limit < got["control"][key]


def test_sweep_reads_the_queue_by_thirds():
    hf = small.GQA
    out = calibrate.sweep(small.cell(hf), [10.0, 200.0], [1], small.SECONDS,
                          device="cpu", port_cfg=small.port_cfg(hf))
    assert [r for r, _ in out] == [10.0, 200.0]
    assert out[1][1]                   # far above what the CPU serves
