#!/usr/bin/env python3
"""The sharded train step on four cards, one rank a card over NCCL:

    python3 tools/dist_cards.py

``chip_smoke.py``'s phase dist on a host with four H100s: for each mesh
("data", "model") of MESHES, gemma_2b and deepseek_v2_lite_16b at full
width (``chip_smoke.DIST_RUNS``: depth the only cut), DIST_STEPS steps of
4 x 1024 tokens in bf16 through ``steps.train_step(..., rules=, mesh=)``,
each rank's exit code checked, and phase dist's gates
(``chip_smoke.dist_report``): flash forward and backward launches on
every rank, every flash call of step 1 held against its plain version,
the replicated loss, aux and grad norm equal on every rank, the loss
against the same steps in one process on card 0, every gathered gradient
leaf's cosine to the one-process gradient. On (1, 4) v2-lite holds 16 of
its 64 experts a rank. Prints each rank's step times and peak memory
beside the card's name and power limit: these are the card's collective
times (phase dist's gloo ranks stage every collective through host
memory). Needs four cards.
"""
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

MESHES = ((2, 2), (1, 4))


def main():
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"needs four cards, found {n}")
    from repro_torch.launch import mesh
    card = cs.card_line()
    cs.log(f"[cards] {n} cards: " + ", ".join(
        torch.cuda.get_device_name(i) for i in range(n)))
    cs.log(card)
    cs.phase_build()
    for shape in MESHES:
        t0 = time.monotonic()
        out_dir = ROOT / "build" / "dist_cards"
        shutil.rmtree(out_dir, ignore_errors=True)
        out_dir.mkdir(parents=True)
        mesh.spawn(cs._dist_rank, 4, (str(out_dir), shape))
        ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
                 for r in range(4)]
        if sorted(r["device"] for r in ranks) != [0, 1, 2, 3]:
            raise AssertionError(f"ranks' cards {[r['device'] for r in ranks]}")
        cs.dist_report(f"cards {shape}", card, shape, ranks,
                       f"4 ranks, one a card, over {ranks[0]['backend']}")
        cs.log(f"[cards] mesh {shape}: {time.monotonic() - t0:.1f} s")
    cs.log("[cards] ok")


if __name__ == "__main__":
    main()
