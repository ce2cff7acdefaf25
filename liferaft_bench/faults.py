"""Faults planted in the timed path, to show that the check catches them.

Each ``plant(name, server)`` wraps the set-up server's step (the port's
``make_serve_step``) so that every later step of the window, and of the
batch decoded after it, carries the fault:

* ``state_unchanged``: the step writes no K/V (the cache's slot at the
  step's position is put back as it was);
* ``half_batch``: the second half of the batch is left out (its rows
  neither written nor decoded; its tokens copied from the first half);
* ``token_altered``: at one step of every request batch (the third), every
  sequence's token is altered (+1 in the vocabulary) where it is produced,
  then served and fed back.

The exchange between chips does not exist in a one-card cell.  The
benchmark's own runs plant nothing: the tests do, at a tiny cut on the
CPU, and ``control.py --fault`` does, at a cell's own size on the card."""
from __future__ import annotations

__all__ = ["FAULTS", "plant"]


def _state_unchanged(server):
    step = server.step_fn

    def broken(params, tok, cache):
        pos = cache["pos"]
        k = cache["k"][:, :, pos].clone()
        v = cache["v"][:, :, pos].clone()
        out = step(params, tok, cache)
        cache["k"][:, :, pos] = k
        cache["v"][:, :, pos] = v
        return out

    server.step_fn = broken


def _half_batch(server):
    import torch

    step = server.step_fn

    def broken(params, tok, cache):
        pos, h = cache["pos"], tok.shape[0] // 2
        k = cache["k"][:, h:, pos].clone()
        v = cache["v"][:, h:, pos].clone()
        nxt, cache = step(params, tok, cache)
        cache["k"][:, h:, pos] = k
        cache["v"][:, h:, pos] = v
        nxt = torch.cat([nxt[:h], nxt[:h]])[: tok.shape[0]]
        return nxt, cache

    server.step_fn = broken


def _token_altered(server):
    step = server.step_fn
    V = server.spec.vocab_size

    def broken(params, tok, cache):
        pos = cache["pos"]
        nxt, cache = step(params, tok, cache)
        if pos == server.P + 2:
            nxt = (nxt + 1) % V
        return nxt, cache

    server.step_fn = broken


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


def plant(name: str, server) -> None:
    FAULTS[name](server)
