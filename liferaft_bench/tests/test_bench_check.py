"""The numbers of ``check.py`` on made-up logits at a served cell's length:
one sequence served wrong moves ``token_gap_seq_max`` and one step served
wrong for every sequence moves ``token_gap_step_max``, where the mean over
every served token barely moves."""
import pytest
import torch

from liferaft_bench import check

S, N, V = 8, 512, 64


def _readings(served_from):
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(S, N, V, generator=g)
    served = served_from(logits.argmax(-1))
    margin = torch.ones(S, N)
    return check._numbers(logits, [], margin, served, [], [], 0.0)


def _second_best(logits):
    return logits.topk(2, dim=-1).indices[..., 1]


def test_greedy_tokens_read_nought():
    r = _readings(lambda best: best)
    for k in ("token_gap", "token_gap_mean", "token_gap_seq_max",
              "token_gap_step_max"):
        assert r[k] == 0.0, r


@pytest.mark.parametrize("where,caught_by", [
    ("one_sequence", "token_gap_seq_max"),
    ("one_step", "token_gap_step_max")])
def test_a_wrong_sequence_or_step_stands_out(where, caught_by):
    def alter(best):
        out = best.clone()
        if where == "one_sequence":
            out[3] = (out[3] + 1) % V
        else:
            out[:, 2] = (out[:, 2] + 1) % V
        return out

    r = _readings(alter)
    other = ({"token_gap_seq_max", "token_gap_step_max"} - {caught_by}).pop()
    assert r[caught_by] > 0.5, r
    assert r["token_gap_mean"] < r[caught_by] / 4, r
    assert r[other] < r[caught_by] / 4, r
