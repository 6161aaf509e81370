"""The comparison that decides ``correct`` for a served model.

For each checked request, the reference runs once over its prompt and the
tokens it was served, and reads at every served position the gap by which
the served token's logit lies below the reference's best logit there: 0
where the program served the reference's own greedy choice. A
configuration compares some of: the widest gap over every checked token,
the mean gap, and the count of tokens whose gap passes its ``wrong_gap``
(a token that is not a near-tie but wrong).

The control puts the reference in the program's place at the precision
below the one configured (``decoder.Fp8``): at each position of the same
prompts and tokens it reads the gap of the token the lower precision puts
first."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import decoder


def _seqs(samples, device):
    out = []
    for prompt, served in samples:
        toks = np.concatenate([np.asarray(prompt, np.int64),
                               np.asarray(served[:-1], np.int64)])
        n = len(prompt)
        out.append((torch.as_tensor(toks, device=device), n,
                    torch.arange(n - 1, n - 1 + len(served), device=device)))
    return out


def gaps(ref: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    """Per row: the reference's best logit less its logit of ``picked``."""
    return ref.max(-1).values - ref.gather(1, picked[:, None])[:, 0]


def summary(g: torch.Tensor, prefix: str = "",
            wrong_gap: Optional[float] = None) -> Dict:
    """The widest, mean, median and 90th-percentile gap, and the share of
    tokens that are not the reference's greedy choice, of gaps ``g``; with
    ``wrong_gap``, the count of tokens whose gap is over it."""
    q = torch.quantile(g, torch.tensor([0.5, 0.9], device=g.device))
    out = {f"{prefix}max_logit_gap": float(g.max()),
           f"{prefix}mean_logit_gap": float(g.mean()),
           f"{prefix}median_logit_gap": float(q[0]),
           f"{prefix}p90_logit_gap": float(q[1]),
           f"{prefix}differ_share": float((g > 0).float().mean())}
    if wrong_gap is not None:
        out[f"{prefix}wrong_tokens"] = int((g > wrong_gap).sum())
    return out


def compare(weights: Dict, model: Dict, max_seq: int,
            samples: Sequence[Tuple[np.ndarray, List[int]]],
            control: bool = False,
            wrong_gap: Optional[float] = None) -> Dict:
    """``summary`` of the served tokens of ``samples`` ((prompt, served
    tokens) pairs) against the float32 reference, with the tokens read
    and the MoE layers' dropped choices; with ``control``, also the fp8
    control's ``summary`` over the same positions, its names prefixed
    ``control_``."""
    device = weights["embedding"].device
    seqs = _seqs(samples, device)
    stats: Dict = {}
    ref = decoder.logits_at(weights, model, seqs, decoder.Precision(),
                            max_seq, stats)
    served = [torch.as_tensor(np.asarray(s, np.int64), device=device)
              for _, s in samples]
    g = torch.cat([gaps(r, s) for r, s in zip(ref, served)])
    out = {**summary(g, wrong_gap=wrong_gap), "tokens": int(g.numel()),
           "moe_dropped": stats.get("dropped", 0),
           "moe_choices": stats.get("choices", 0)}
    if control:
        low = decoder.logits_at(weights, model, seqs, decoder.Fp8(),
                                max_seq)
        cg = torch.cat([gaps(r, c.argmax(-1)) for r, c in zip(ref, low)])
        out.update(summary(cg, "control_", wrong_gap))
    return out
