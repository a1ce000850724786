"""Chrome-trace JSON export of request execution (paper §III-F2)."""
from __future__ import annotations

import json
from typing import List

from repro_torch.core.request import Request


def to_chrome_trace(requests: List[Request], path: str):
    events = []
    for r in requests:
        for st in r.stages:
            if st.start_time is None or st.end_time is None:
                continue
            events.append({
                "name": st.kind,
                "cat": "stage",
                "ph": "X",
                "ts": st.start_time * 1e6,
                "dur": max(0.0, (st.end_time - st.start_time)) * 1e6,
                "pid": st.client or "unassigned",
                "tid": r.rid,
                "args": {"input_tokens": r.input_tokens,
                         "output_tokens": r.output_tokens,
                         "branches": r.branches},
            })
        if r.first_token_time is not None:
            events.append({"name": "first_token", "cat": "token", "ph": "i",
                           "ts": r.first_token_time * 1e6, "pid": "tokens",
                           "tid": r.rid, "s": "t"})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path
