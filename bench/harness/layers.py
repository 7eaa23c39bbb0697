"""Layer-by-layer readings of the served path, for the comparison that
decides `correct`.

Once the window has closed (and an open loop's late requests are served),
the harness arms a tap on the engine's prefill and decode steps.  The next
call of each runs as every call in the window does (the captured graph,
whose tokens the engine goes on with), and then once more eagerly: the
same step function, the same kernels, on the same inputs and the same
pool, with each block's input, attention output and FFN output, and the
lm_head's input and logits, recorded on the way (`LayerTap`).  Right then,
while the pool holds what the step read, the plain reference
(`reference.model`, the masters drawn again from the seed) computes every
layer again from the program's input to that layer:

- ``attn_decode_err``, ``attn_prefill_err``: the attention half (norm,
  the W4A4 q/k/v projections, rotation, paged decode over the pool's
  earlier keys and values or flash prefill over the prompt, the W4A4
  output projection) against the program's, the relative error over the
  step's real rows, the widest over the layers; ``attn_prefill_row_err``
  the widest of one row's, which a fault confined to a few positions of a
  long prompt moves where the whole step's error hides it;
- ``ffn_err``: the FFN half from the program's residual after attention,
  the same, over both steps;
- ``kv_write_err``: the keys and values each layer wrote to the pool for
  the step's positions against the reference's, the median over the
  positions of each one's relative error, the widest over the layers and
  both steps;
- ``head_err``: the lm_head's logits from the last block's output;
- ``replay_mismatch``: rows whose token from the captured graph differs
  from the eager step's.

The reference reads the program's activations and its pool only to judge
them: each layer's input comes from the program, so no difference is
amplified from one layer to the next, and a decode row attends over the
keys and values the program cached at earlier steps (the start, layer 0 of
the pool from the tokens alone, is read apart: ``kv0_rel_err``).
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional

import torch

from reference.masters import dims, draw_block, draw_globals
from reference.model import (attention, attn_in, attn_out, ffn_part,
                             fp32_matmuls, head, quantized, rounder)

#: what each step kind's tap reads, by name
KINDS = ("prefill", "decode")


class LayerTap:
    """While entered, records each block's input (``x``), attention output
    (``attn``) and FFN output (``ffn``), and the lm_head's input and
    logits, as the program's forward computes them."""

    def __init__(self):
        self.blocks: List[Dict[str, torch.Tensor]] = []
        self.head_in: Optional[torch.Tensor] = None
        self.logits: Optional[torch.Tensor] = None

    def __enter__(self):
        from repro_torch.models import transformer as tr

        self._tr = tr
        self._saved = (tr.apply_block, tr.apply_attention, tr.apply_ffn,
                       tr._logits)
        block, attn, ffn, logits = self._saved
        tap = self

        def apply_block(bt, p, x, *args, **kw):
            tap.blocks.append({"x": x})
            out = block(bt, p, x, *args, **kw)
            tap.blocks[-1]["out"] = out[0]
            return out

        def apply_attention(*args, **kw):
            y, cache = attn(*args, **kw)
            tap.blocks[-1]["attn"] = y
            return y, cache

        def apply_ffn(*args, **kw):
            y = ffn(*args, **kw)
            tap.blocks[-1]["ffn"] = y
            return y

        def _logits(params, x, cfg, rt):
            y = logits(params, x, cfg, rt)
            tap.head_in, tap.logits = x, y
            return y

        tr.apply_block, tr.apply_attention = apply_block, apply_attention
        tr.apply_ffn, tr._logits = apply_ffn, _logits
        return self

    def __exit__(self, *exc):
        tr = self._tr
        (tr.apply_block, tr.apply_attention, tr.apply_ffn,
         tr._logits) = self._saved
        return False


class StepTap:
    """An engine step that, once armed, hands its next call to
    `on_tap(kind, call)` after running it: the captured step's tokens
    (``replayed``), the eager step's (``eager``) with its `LayerTap`, and
    the step's inputs and pool."""

    def __init__(self, step, kind: str, on_tap: Callable):
        self.step, self.kind, self.on_tap = step, kind, on_tap
        self.armed = False

    def __call__(self, params, tokens, caches, positions, tbl_all, slots,
                 *rest):
        out, caches = self.step(params, tokens, caches, positions, tbl_all,
                                slots, *rest)
        if not self.armed:
            return out, caches
        self.armed = False
        # the graph's output is overwritten by its next replay: read it now
        replayed = out.detach().to("cpu", copy=True)
        dev = tbl_all.device
        tokens, positions, slots = (t.to(dev) for t in
                                    (tokens, positions, slots))
        eager = self.step
        # the step function under every wrapper: a captured step's, or
        # under a test's fault, the one it wraps
        while not inspect.isfunction(eager) and hasattr(eager, "fn"):
            eager = eager.fn
        with LayerTap() as taps:
            e_out, _ = eager(params, tokens, caches, positions, tbl_all,
                             slots, *rest)
        self.on_tap(self.kind, {"replayed": replayed,
                                "eager": e_out.detach().cpu(),
                                "taps": taps, "positions": positions,
                                "slots": slots, "tbl": tbl_all,
                                "pool": caches["rep"]["u0"]["attn"]})
        return out, caches

    def __getattr__(self, key):
        return getattr(self.step, key)


def install(engine, on_tap: Callable) -> Dict[str, StepTap]:
    """Wrap the engine's fresh-prefill and decode steps in taps."""
    taps = {"prefill": StepTap(engine._prefill, "prefill", on_tap),
            "decode": StepTap(engine._decode, "decode", on_tap)}
    engine._prefill, engine._decode = taps["prefill"], taps["decode"]
    return taps


def _pool_rows(pool: Dict, layer: int, pages: torch.Tensor, upto: int):
    """Layer `layer`'s keys and values [upto, KV, hd] (float32) of the
    positions 0..upto-1 of a row whose pages are `pages`."""
    ps = pool["k"].shape[2]
    pages = pages[:-(-upto // ps)]
    out = []
    for name in ("k", "v"):
        x = pool[name][layer][pages].to(torch.float32)
        if name + "_scale" in pool:
            x = x * pool[name + "_scale"][layer][pages]
        out.append(x.reshape(-1, *x.shape[-2:])[:upto].to(torch.float32))
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest relative error of one row."""
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


def _kv_rel(got, want) -> float:
    """The median over the rows (positions) of the relative error of the
    keys and values written for each: a lower precision moves every row,
    while a code on a tie, which the order of a sum can move, moves one."""
    num = sum((g - w).pow(2).sum(dim=(1, 2)) for g, w in zip(got, want))
    den = sum(w.pow(2).sum(dim=(1, 2)) for w in want)
    return float((num / den.clamp_min(1e-30)).sqrt().median())


class Reader:
    """The readings of the tapped steps: `__call__` is a `StepTap`'s
    `on_tap`.  With `acts` it also reads each lower precision's reference
    in the program's place (the controls), from the same inputs, against
    the reference in the stored precision."""

    def __init__(self, model: Dict, seed: int, stored: torch.dtype,
                 acts=()):
        self.model, self.seed, self.stored = model, seed, stored
        self.acts = tuple(acts)
        self.readings: Dict[str, Dict[str, float]] = {}
        self.controls: Dict[str, Dict[str, Dict[str, float]]] = {
            str(a): {} for a in self.acts}

    @property
    def done(self) -> bool:
        return all(k in self.readings for k in KINDS)

    @torch.no_grad()
    def __call__(self, kind: str, call: Dict) -> None:
        if not call["taps"].blocks:
            return          # no eager forward ran: nothing to read
        fp32_matmuls()
        model, d = self.model, dims(self.model)
        window = int(model.get("sliding_window") or 0)
        taps, pool = call["taps"], call["pool"]
        posn = call["positions"].long()
        if kind == "prefill":
            # one left-padded sequence: its real rows, at 0..n-1
            rows = (posn[0] >= 0).nonzero()[:, 0]
            P = posn[0, rows]
        else:
            rows = (posn[:, -1] >= 0).nonzero()[:, 0]
            P = posn[rows, -1]
        dev = P.device
        pages = call["tbl"][call["slots"].long()].long()
        batch_rows = [0] if kind == "prefill" else rows.tolist()

        def take(t):        # the real rows of a recorded [B, S, ...] tensor
            t = t.to(torch.float32)
            return t[0, rows] if kind == "prefill" else t[rows, 0]

        acts = [self.stored, *self.acts]
        worst = {str(a): {"attn": 0.0, "attn_row": 0.0, "ffn": 0.0,
                          "kv": 0.0} for a in acts}
        for layer, rec in enumerate(taps.blocks):
            p = quantized(draw_block(model, self.seed, layer, dev))
            x, a_prog, f_prog = (take(rec[k]) for k in ("x", "attn", "ffn"))
            # each row's cached keys and values, the step's own last
            if kind == "prefill":
                cached = [_pool_rows(pool, layer, pages[0], len(rows))]
                wrote = cached[0]
            else:
                cached = [_pool_rows(pool, layer, pages[b], int(n) + 1)
                          for b, n in zip(batch_rows, P.tolist())]
                wrote = [torch.stack([c[j][-1] for c in cached])
                         for j in (0, 1)]
            refs = {}
            for act in acts:
                rnd = rounder(act)
                q, k, v = attn_in(rnd(x), p, d, model, P, rnd)
                if kind == "prefill":
                    o = attention(q, k, v, window)
                else:
                    o = torch.cat([attention(
                        q[i:i + 1],
                        torch.cat([rnd(c[0][:-1]), k[i:i + 1]]),
                        torch.cat([rnd(c[1][:-1]), v[i:i + 1]]), window)
                        for i, c in enumerate(cached)])
                refs[act] = (attn_out(rnd(o), p, rnd),
                             ffn_part(rnd(x + a_prog), p, d, model, rnd),
                             (k, v))
            # the stored precision's reference judges the program, and the
            # program's place taken by a lower precision's (the controls)
            want = refs[self.stored]
            for act, got in [(self.stored, (a_prog, f_prog, wrote))] + \
                    [(a, refs[a]) for a in self.acts]:
                w = worst[str(act)]
                w["attn"] = max(w["attn"], _rel(got[0], want[0]))
                w["ffn"] = max(w["ffn"], _rel(got[1], want[1]))
                w["attn_row"] = max(w["attn_row"], _row_rel(got[0], want[0]))
                w["kv"] = max(w["kv"], _kv_rel(got[2], want[2]))
            del p, refs, cached
        g = draw_globals(model, self.seed, dev)
        last = take(taps.blocks[-1]["out"])
        if kind == "prefill":       # the prompt's last row gives the token
            last, pick, host = last[-1:], slice(0, 1), slice(0, 1)
        else:
            pick, host = rows, rows.cpu()

        def logits_in(act):
            return head(rounder(act)(last), g["final_norm"], g["lm_head"],
                        model, rounder(act))

        want = logits_in(self.stored)
        got = taps.logits[:, -1, :d["V"]].to(torch.float32)[pick]
        # the captured step's tokens held to the eager step's
        mismatch = call["replayed"][host] != call["eager"][host]
        self.readings[kind] = dict(worst[str(self.stored)],
                                   head=_rel(got, want),
                                   replay=float(mismatch.sum()))
        for a in self.acts:
            self.controls[str(a)][kind] = dict(
                worst[str(a)], head=_rel(logits_in(a), want))


def compared(read: Dict) -> Dict[str, Optional[float]]:
    """The compared numbers of `read` (a `Reader`'s readings, or one
    control's); None where a step was never tapped."""
    pre, dec = read.get("prefill"), read.get("decode")

    def both(key):
        vals = [r[key] for r in (pre, dec) if r is not None and key in r]
        return max(vals) if len(vals) == 2 else None

    return {"attn_decode_err": dec["attn"] if dec else None,
            "attn_prefill_err": pre["attn"] if pre else None,
            "ffn_err": both("ffn"), "kv_write_err": both("kv"),
            "attn_prefill_row_err": pre["attn_row"] if pre else None,
            "head_err": both("head"), "replay_mismatch": both("replay")}
