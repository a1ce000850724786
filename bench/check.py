"""How ``correct`` is decided for a served model: a sample, drawn from the
seed, of the requests the program finished (the longest among them), and
the family's plain fp32 reference run once over each prompt with its
served tokens.

At each served token, how far that token's reference logit lies below the
reference's best logit at that position, in units of the standard
deviation of the reference's logits there. ``gap`` is the widest over the
sample, ``mean_gap`` the mean; a configuration's ``limits`` name the ones
compared (a MoE's widest gap is set by routing flips, which bf16 and the
control share). It holds greedy tokens only (the traffic samples none).
``short``: sampled requests that streamed another number of tokens than
asked (exact: limit 0).

The control (``calibrate.py``, not the benchmark's runs) is the same
reference in fp8 in the program's place: at the same positions, the gap of
the token the fp8 logits put first, judged by ``read`` at the cell's limits
as the program's tokens are.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def sample(finished, seed: int, check: dict) -> list:
    """The requests to check: the longest finished one, then others in an
    order drawn from ``seed``, each unless it would take the sample past
    ``check["seq_tokens"]`` tokens of prompt and output, until there are
    ``check["requests"]``. Several requests, so that a fault confined to
    some slots of the batch shows."""
    if not finished:
        return []
    size = [len(r.prompt) + len(r.tokens) for r in finished]
    order = [int(np.argmax(size))]
    total = size[order[0]]
    for i in np.random.default_rng(seed).permutation(len(finished)):
        if len(order) >= check["requests"]:
            break
        if i == order[0] or total + size[i] > check["seq_tokens"]:
            continue
        order.append(int(i))
        total += size[i]
    return [finished[i] for i in order]


def sequences(reqs):
    """(token sequences, positions of the served tokens' logits): a
    sequence is the prompt and every served token but the last; served
    token j is predicted at position ``len(prompt) - 1 + j``."""
    seqs, want = [], []
    for r in reqs:
        seqs.append(torch.as_tensor(np.concatenate(
            [r.prompt, np.asarray(r.tokens[:-1], np.int32)]).astype(np.int64)))
        want.append(list(range(len(r.prompt) - 1,
                               len(r.prompt) - 1 + len(r.tokens))))
    return seqs, want


def gaps(ref_logits: List[torch.Tensor], tokens: List[torch.Tensor]
         ) -> torch.Tensor:
    """Per position: (best reference logit - the token's), over the
    reference logits' standard deviation there."""
    out = []
    for lg, tok in zip(ref_logits, tokens):
        tok = tok.to(lg.device).long()
        out.append((lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0])
                   / lg.std(-1))
    return torch.cat(out)


def served_tokens(reqs) -> List[torch.Tensor]:
    return [torch.as_tensor(np.asarray(r.tokens, np.int64)) for r in reqs]


def read(ref_logits, tokens, reqs, limits: Dict[str, float]
         ) -> Dict[str, dict]:
    """The numbers that ``limits`` names (``gap``, the widest; ``mean_gap``,
    the mean over every judged token) of ``tokens`` against the reference
    logits, each beside its limit, and ``short``."""
    g = gaps(ref_logits, tokens) if reqs else None
    # no finished request to judge reads as failing
    got = {"gap": float(g.max()) if reqs else 1e9,
           "mean_gap": float(g.mean()) if reqs else 1e9}
    out = {k: {"value": got[k], "limit": v} for k, v in limits.items()}
    out["short"] = {"value": sum(len(r.tokens) != r.max_new_tokens
                                 for r in reqs), "limit": 0}
    return out


def judge(ref, hf: dict, params: dict, reqs, limits: Dict[str, float]
          ) -> Dict[str, dict]:
    """``read`` of the served tokens of ``reqs`` against the family's fp32
    reference."""
    seqs, want = sequences(reqs)
    lg = ref.logits(hf, params, seqs, want, "fp32")
    return read(lg, served_tokens(reqs), reqs, limits)


def _stats(g: torch.Tensor) -> Dict[str, float]:
    return {"max": float(g.max()), "p99": float(g.quantile(0.99)),
            "mean": float(g.mean()), "off_argmax": float((g > 0).float().mean())}


def control(ref, hf: dict, params: dict, reqs, limits: Dict[str, float]
            ) -> Dict[str, object]:
    """The program's gaps and the fp8 control's, on the same prompts and
    served tokens, and a witness: the reference in bf16 (operands and
    products of its linear layers rounded to bf16), the program's
    precision without its code. Each: the widest, the 99th percentile,
    the mean and the share of tokens off the fp32 reference's argmax; and
    the program's and the control's numbers judged at ``limits`` as a run
    judges them, with ``correct`` (the control's has to be false)."""
    seqs, want = sequences(reqs)
    lg = ref.logits(hf, params, seqs, want, "fp32")
    lo = ref.logits(hf, params, seqs, want, "fp8")
    lb = ref.logits(hf, params, seqs, want, "bf16")
    served, fp8 = served_tokens(reqs), [x.argmax(-1) for x in lo]
    prog, ctl = read(lg, served, reqs, limits), read(lg, fp8, reqs, limits)
    return {"program": _stats(gaps(lg, served)),
            "control": _stats(gaps(lg, fp8)),
            "bf16_reference": _stats(gaps(lg, [x.argmax(-1) for x in lb])),
            "program_checks": prog, "program_correct": passed(prog),
            "control_checks": ctl, "control_correct": passed(ctl),
            "served_tokens": sum(len(r.tokens) for r in reqs)}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
