"""Tiny cells for the harness's CPU tests: the cells' own shape (a
Mistral-family decoder, GQA, SwiGLU, top-2 experts) at widths a CPU run
holds in a second."""
import copy
import pathlib
import sys

import pytest

_ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(_ROOT / "src"), str(_ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from liferaft_bench import manifest  # noqa: E402

TINY_MOE = {
    "name": "tiny-moe", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 6,
    "num_key_value_heads": 2, "head_dim": 16, "num_local_experts": 4,
    "num_experts_per_tok": 2, "vocab_size": 512, "rope_theta": 1e6,
    "rms_norm_eps": 1e-5, "sliding_window": None, "hidden_act": "silu",
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
}
TINY_DENSE = dict(TINY_MOE, name="tiny-dense", hidden_size=128,
                  intermediate_size=256, num_attention_heads=8,
                  num_key_value_heads=2, head_dim=16)
for k in ("num_local_experts", "num_experts_per_tok"):
    del TINY_DENSE[k]
TINY_MIX = {"batch": 4, "prompt_len": 24, "new_tokens": 8, "cache_slots": 32,
            "warm_steps": 2, "check_sequences": 3, "check_last_batch": 2}
# Cells lend their names to the tiny ones (the metrics a cell reports).
DENSE_CELL = "mistral-large-123b.decode-1k-b64"
MOE_CELL = "mixtral-8x22b.decode-spread-b384"


@pytest.fixture(scope="session")
def bench():
    return manifest.load()


def tiny_cell(config: dict, limits: dict, name: str = DENSE_CELL, **mix):
    return manifest.Cell({"name": name, "chips": 1}, copy.deepcopy(config),
                         dict(TINY_MIX, **mix), limits)
