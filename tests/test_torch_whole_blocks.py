"""The port's layout of the blocks whose heads do not divide "model":
MLA's attention (minicpm3_4b's 40 heads on the production mesh's 16 model
ranks) and the ssm family's mLSTM and sLSTM layers (xlstm_1_3b's 4 heads),
where JAX's rules put "model" on the latents' rank dims or on the inner
channels, run whole on every model rank (``transformer.param_specs``).
Reduced, fp32, on 8 gloo ranks of mesh (1, 8) (4 heads on 8 model ranks):
the sharded gradient and the sharded prefill + decode steps equal the
one-process port's (``_torch_dist_jobs.job_whole``)."""
import json

import numpy as np
import pytest

import _torch_dist_jobs as jobs
from repro_torch.launch import mesh as tmesh

FP32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
# fp32 on both sides, the rest of the model sharded as before: sums over
# the ranks in other orders than one process's. Loss and gradient: as the
# other sharded steps' tests. Logits of the prefill and 2 decode steps, of
# the largest: measured 1.49e-5 (minicpm3 naive), 1.8e-7 (absorbed), 0
# (xlstm); gradients 7.8e-7 to 9.5e-7: the MLP's and the head's sums over
# 8 model ranks
RTOL = 1e-5
LOGIT_RTOL = 3e-5
CASES = {
    "mla": {"arch": "minicpm3_4b", "whole": ["layers.attn."]},
    "mla_absorb": {"arch": "minicpm3_4b", "whole": ["layers.attn."],
                   "mla": {"absorb": True}},
    "xlstm": {"arch": "xlstm_1_3b", "whole": ["mlstm.", "slstm."]},
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("whole"))
    specs = [{"job": "whole", "name": name, "replace": FP32,
              "mesh": [1, 8], "axes": ["data", "model"], "seed": i,
              "seq": 32, "max_len": 40, "steps": 2, **case}
             for i, (name, case) in enumerate(CASES.items())]
    with open(f"{d}/jobs.json", "w") as f:
        json.dump(specs, f)
    tmesh.spawn(jobs.run, 8, (d,), device="cpu")
    return d


@pytest.mark.parametrize("name", list(CASES))
def test_whole_blocks_equal_one_process(ranks, name):
    out = dict(np.load(f"{ranks}/out_whole_{name}.npz"))
    assert int(out["whole_leaves"]) > 0 and int(out["whole_model"]) == 0
    # the rest of the model stays split over "model" (the vocabulary)
    assert int(out["split_model"]) > 0
    np.testing.assert_allclose(out["loss"][0], out["loss"][1], rtol=RTOL)
    assert float(out["grad_err"]) < RTOL
    assert float(out["logit_err"]) < LOGIT_RTOL
