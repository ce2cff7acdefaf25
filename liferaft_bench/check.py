"""What decides ``correct``: the served tokens and the written K/V against
the plain reference, on a sample drawn from the seed.

After the window (and the batch in flight, decoded to its end), a sample
of the finished requests is drawn: ``check_sequences`` of them, at least
``check_last_batch`` from the last request batch, whose K/V the cache still
holds.  The reference (``reference.decoder``, float32) is fed each
sequence's first token and its served tokens, from the prefilled K/V that
the inputs draw again from the seed, and gives the logits at every
position and each layer's K/V.  Five numbers are worked out:

* ``token_gap``: the widest gap by which a served token's logit lies below
  the reference's best at that position (0 where the program served the
  reference's greedy token);
* ``token_gap_mean``: the same gap's mean over every served token;
* ``token_gap_seq_max``: the same gap's mean over each sampled sequence's
  served tokens, the worst sequence's (one sequence served wrong does not
  hide among the sound ones);
* ``token_gap_step_max``: the same gap's median over the sampled sequences
  at each decode step, the worst step's (a step served wrong for every
  user does not hide among the sound steps);
* ``kv_rel_err``: over the last batch's sampled sequences, every layer's
  K and V written at the decoded slots against the reference's, as
  ||program - reference|| / ||reference||, the worst of them.

``token_gap`` and ``kv_rel_err`` skip the positions whose routing margin
(``reference_pass``) is at most the cell's ``routing_margin`` (0 for a
model without experts: no position is skipped).  A cell compares the
numbers its ``limits/<cell>.json`` names, each with the limit set there
from the program's readings over a dozen seeds and more and the fp8
control's (``control.py``).  A served token outside the vocabulary, or a
sequence short of its tokens, fails outright.
"""
from __future__ import annotations

import numpy as np
import torch

from . import inputs
from .reference.decoder import reference_pass

__all__ = ["NUMBERS", "draw_sample", "Sample", "compare", "judge"]

NUMBERS = ("token_gap", "token_gap_mean", "token_gap_seq_max",
           "token_gap_step_max", "kv_rel_err")


def draw_sample(batches: list, n_check: int, n_last: int, seed: int) -> list:
    """(batch index, row) of the sequences to compare: ``n_last`` rows of
    the last batch, the rest from every batch, distinct, drawn from the
    seed."""
    B = len(batches[-1][0])
    last = len(batches) - 1
    rng = inputs.sample_rng(seed)
    picked = [(last, int(r)) for r in rng.choice(B, size=min(n_last, B),
                                                 replace=False)]
    pool = [(b, r) for b in range(len(batches)) for r in range(B)
            if (b, r) not in picked]
    more = min(n_check - len(picked), len(pool))
    for i in rng.choice(len(pool), size=more, replace=False):
        picked.append(pool[int(i)])
    return sorted(picked)


class Sample:
    """The sampled sequences' tokens ((S, n + 1) int64) and, for those of
    the last batch, the K/V the program wrote ((S_last, L, n, KV, D))."""

    def __init__(self, picked: list, batches: list, written: tuple,
                 last_rows: list):
        self.picked = picked
        self.tokens = torch.from_numpy(np.stack(
            [np.stack(batches[b])[:, r] for b, r in picked]).astype(np.int64))
        self.written = written
        self.last_rows = last_rows  # indices into picked

    @classmethod
    def take(cls, server, batches: list, mix: dict, seed: int) -> "Sample":
        picked = draw_sample(batches, mix["check_sequences"],
                             mix["check_last_batch"], seed)
        last = len(batches) - 1
        last_rows = [i for i, (b, _) in enumerate(picked) if b == last]
        written = server.written_kv([picked[i][1] for i in last_rows])
        return cls(picked, batches, written, last_rows)


def _prefill(spec, seed, mix, rows, device, dtype):
    def get(layer):
        k, v = inputs.prefill_kv(spec, seed, layer, mix["batch"],
                                 mix["prompt_len"], device, dtype)
        idx = torch.tensor(rows, device=device)
        return k.index_select(0, idx), v.index_select(0, idx)
    return get


def _rel(a: torch.Tensor, r: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.float() - r)
                 / torch.linalg.vector_norm(r).clamp(min=1e-30))


def compare(spec, weights: dict, sample: Sample, mix: dict, seed: int,
            device, routing_margin: float = 0.0, control: str | None = None,
            margins: tuple = ()) -> dict:
    """The numbers for ``sample``, over the positions whose routing margin
    (``reference_pass``) exceeds ``routing_margin``.  With ``control`` (a
    precision of the reference: "fp8" below bf16), also the reference's in
    that precision in the program's place, ``control_<number>`` (its gaps
    are those of the token it puts first).  ``margins``: the numbers again
    at each of these margins, keyed ``<number>@<margin>``."""
    n = mix["new_tokens"]
    tokens = sample.tokens
    V = spec.vocab_size
    served = tokens[:, 1:]
    if served.shape[1] != n or bool(((served < 0) | (served >= V)).any()):
        return dict.fromkeys(NUMBERS, float("inf"))
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            rows = [r for _, r in sample.picked]
            pre = _prefill(spec, seed, mix, rows, device,
                           weights["embed"].dtype)
            fed = tokens[:, :n]
            logits, kv, margin = reference_pass(spec, weights, pre, fed,
                                                mix["prompt_len"])
            served = served.to(logits.device)
            written = [(wk[:, i], wv[:, i]) for wk, wv in [sample.written]
                       for i in range(wk.shape[1])]
            out = _numbers(logits, kv, margin, served, written,
                           sample.last_rows, routing_margin)
            out["routing_margin_min"] = float(margin.min())
            for mg in margins:
                out.update({f"{k}@{mg}": v for k, v in _numbers(
                    logits, kv, margin, served, written, sample.last_rows,
                    mg).items()})
            if control:
                lc, kvc, _ = reference_pass(spec, weights, pre, fed,
                                            mix["prompt_len"], control)
                put = lc.argmax(-1)
                every = list(range(len(rows)))
                for mg in (routing_margin, *margins):
                    tag = "" if mg == routing_margin else f"@{mg}"
                    out.update({f"control_{k}{tag}": v for k, v in _numbers(
                        logits, kv, margin, put, kvc, every, mg).items()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev_tf32
    return out


def _numbers(logits, kv, margin, served, written, rows: list,
             routing_margin: float) -> dict:
    """``written``: a layer's (k, v) for the sequences ``rows`` of the
    sample (their indices), in the program's place."""
    gaps = (logits.max(-1).values
            - logits.gather(-1, served[..., None])[..., 0])  # (S, n)
    keep = margin > routing_margin
    out = {"token_gap": float(gaps[keep].max()) if bool(keep.any())
           else float("inf"),
           "token_gap_mean": float(gaps.mean()),
           "token_gap_seq_max": float(gaps.mean(-1).max()),
           "token_gap_step_max": float(gaps.quantile(0.5, dim=0).max()),
           "decisive_share": float(keep.float().mean())}
    err = 0.0
    if rows:
        idx = torch.tensor(rows, device=logits.device)
        k_rows = keep.index_select(0, idx)
        for (wk, wv), (rk, rv) in zip(written, kv):
            for w, r in ((wk, rk), (wv, rv)):
                w = w.to(r.device)[k_rows]
                err = max(err, _rel(w, r.index_select(0, idx)[k_rows]))
    out["kv_rel_err"] = err
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number that
    ``limits["numbers"]`` names at most its limit."""
    checks = {k: {"value": numbers[k], "limit": v["limit"]}
              for k, v in limits["numbers"].items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
