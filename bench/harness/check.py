"""The comparison that decides `correct`, made once the window has closed,
against the plain reference (`reference.model`) computed from the run's
seed alone.

W4A4 is chaotic: every projection quantizes its input rows to int4, so a
difference in the last bit of an activation moves some codes by a whole
step, and the next layers amplify it.  Over 32 or 48 layers the served
program (bfloat16) and a reference in float32 or in a lower precision
drift apart to much the same distance.  So the comparison reads each
stage where nothing has been amplified yet:

- ``kv0_rel_err``, the start: the keys and values of layer 0 that the
  program wrote to its paged pool for a sample of the requests live at the
  window's close (the longest always in it), against the reference's
  layer 0 from the same tokens, in the stored precision (bfloat16);
- every layer of a prefill and a decode step, each from the program's
  input to it (`layers`): attention, FFN, the pool's writes, the lm_head;
- ``median_rank_share``, end to end: for every served token of a sample
  of the finished requests (the longest always in it), the share of the
  vocabulary whose float32 reference logit lies above the served token's,
  the whole forward teacher-forced on prompt and served tokens; the median
  over the tokens.  A served token stays near the top under the chaos; a
  wrong token lands anywhere.  The 90th percentile of the share and the
  widest and median gaps of the served tokens' logits below the
  reference's best are read beside it: they read alike for the program
  and a lower precision, so they are shown and not compared.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reference.model import kv_layer0, logits_at

from .traffic import rng


def sample(recs: Sequence, n: int, seed: int, size, stream: int) -> List:
    """`n` of `recs`: the one of largest `size`, and the rest drawn from
    the seed."""
    if not recs:
        return []
    by = sorted(recs, key=lambda r: (-size(r), r.idx))
    rest = by[1:]
    pick = rng(seed, stream).permutation(len(rest))[:max(n - 1, 0)]
    return [by[0]] + [rest[i] for i in sorted(pick)]


def pool_layer0(engine, live: Sequence) -> List[Dict]:
    """Layer 0's keys and values [n, KV, hd] (float32, on the host) that the
    engine holds for each live request, over its n cached positions, with
    the n tokens they were computed from."""
    pool = engine.caches["rep"]["u0"]["attn"]
    out = []
    for r in live:
        req = r.req
        n = req.n_cached
        idx = torch.tensor(engine.kv.pages[req.rid], dtype=torch.long,
                           device=pool["k"].device)
        got = {}
        for name in ("k", "v"):
            x = pool[name][0][idx]
            if name + "_scale" in pool:
                from_int = x.to(torch.float32)
                x = from_int * pool[name + "_scale"][0][idx]
            x = x.reshape(-1, *x.shape[-2:])[:n].to(torch.float32).cpu()
            got[name] = x
        toks = np.concatenate([np.asarray(req.prompt, np.int64),
                               np.asarray(req.tokens, np.int64)])[:n]
        out.append({"tokens": toks, **got})
    return out


def kv0_error(model: Dict, seed: int, held: Sequence[Dict], device,
              stored: torch.dtype, act: Optional[torch.dtype] = None
              ) -> Optional[float]:
    """The widest, over the sampled requests, relative error of layer 0's
    keys and values: the program's (`held`), or with `act` the reference's
    in that lower precision (the control), against the reference in the
    configuration's `stored` precision."""
    if not held:
        return None
    seqs = [torch.from_numpy(h["tokens"]).to(device) for h in held]
    ref = kv_layer0(model, seed, seqs, stored, device)
    got = (kv_layer0(model, seed, seqs, act, device) if act is not None
           else [(h["k"].to(device), h["v"].to(device)) for h in held])
    worst = 0.0
    for (rk, rv), (gk, gv) in zip(ref, got):
        num = (gk - rk).pow(2).sum() + (gv - rv).pow(2).sum()
        den = rk.pow(2).sum() + rv.pow(2).sum()
        worst = max(worst, float((num / den).sqrt()))
    return worst


def logit_gaps(model: Dict, seed: int, reqs: Sequence, device,
               act: Optional[torch.dtype] = None) -> Dict:
    """The float32 reference's gaps of the served tokens of `reqs` (act
    None), or of the tokens a reference computed in `act` would serve in
    their place (the control): widest and median gap, median rank share,
    how many."""
    seqs, rows, served = [], [], []
    for r in reqs:
        toks = np.asarray(r.tokens, np.int64)
        P = len(r.prompt)
        full = np.concatenate([np.asarray(r.prompt, np.int64), toks[:-1]])
        seqs.append(torch.from_numpy(full).to(device))
        rows.append(torch.arange(P - 1, P - 1 + len(toks), device=device))
        served.append(torch.from_numpy(toks).to(device))
    vocab = model["vocab_size"]
    bad = sum(int(((s < 0) | (s >= vocab)).sum()) for s in served)
    if not seqs:
        return {"max": None, "median": None, "rank_share": None,
                "rank_share_p90": None, "tokens": 0, "out_of_vocab": 0}
    ref = logits_at(model, seed, seqs, rows, None, device)
    if act is not None:
        served = [c.argmax(dim=-1) for c in
                  logits_at(model, seed, seqs, rows, act, device)]
    gaps, ranks = [], []
    for lg, s in zip(ref, served):
        s = s.clamp(0, lg.shape[-1] - 1)
        mine = lg.gather(1, s[:, None])
        gaps.append(lg.max(dim=-1).values - mine[:, 0])
        ranks.append((lg > mine).sum(dim=-1).to(torch.float32) / vocab)
    g, r = torch.cat(gaps), torch.cat(ranks)
    return {"max": float(g.max()), "median": float(g.median()),
            "rank_share": float(r.median()),
            "rank_share_p90": float(torch.quantile(r, 0.9)),
            "tokens": int(g.numel()),
            "out_of_vocab": bad}


def judge(readings: Dict, limits: Dict) -> Dict:
    """Each compared number beside its limit, and whether every one holds.
    A number the limits file does not name is not compared."""
    rows, ok = {}, True
    for name, limit in limits.items():
        if name.startswith("min_"):
            value = readings.get(name[4:])
            holds = value is not None and value >= limit
        else:
            value = readings.get(name)
            holds = value is not None and value <= limit
        rows[name] = {"value": value, "limit": limit,
                      "holds": "<=" if not name.startswith("min_") else ">="}
        ok = ok and holds
    return {"correct": ok, "numbers": rows}
