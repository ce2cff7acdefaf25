"""The drivers on a card: the SkyQuery example and Fig. 2's measured view.

Marked ``cuda``: they skip without a card.  They import only the port
(the card's machine has no JAX):

    python -m pytest -q -m cuda tests/test_torch_drivers_cuda.py

* ``examples.crossmatch_skyquery`` on the card: one K1 launch a device
  dispatch, the engine summary equal to a ``device="cpu"`` run's;
* Fig. 2's measured view on the card at w in {8, 64}: every join one
  launch, each w's scan held against the plain version on the CPU under
  the join contract (``assert_join_close``), and the device-part times
  measured.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import fig2_hybrid_join as fig2  # noqa: E402
from repro_torch.examples import crossmatch_skyquery as sky  # noqa: E402
from repro_torch.kernels.crossmatch import kernel as tkernel  # noqa: E402
from repro_torch.kernels.crossmatch import ops as tops  # noqa: E402
from test_torch_kernels_cuda import assert_join_close  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_skyquery_example_on_the_card(card, tmp_path):
    tkernel.reset_launches()
    got = sky.run(queries=20, device=card, out_path=tmp_path / "r.json",
                  verbose=False)
    launched = dict(tkernel.LAUNCHES)
    want = sky.run(queries=20, device="cpu", out_path=None, verbose=False)
    assert launched["crossmatch"] == got["summary"]["device_dispatches"] > 0
    assert sum(launched.values()) == launched["crossmatch"]
    assert got["summary"] == want["summary"]
    assert got["device"] != "cpu"


@pytest.mark.cuda
def test_fig2_measured_view_on_the_card(card):
    tkernel.reset_launches()
    rows, joins, calls = fig2.measured_view(verbose=False, device=card,
                                            widths=(8, 64))
    assert tkernel.LAUNCHES["crossmatch"] == calls
    for j in joins:
        want = tops.crossmatch(j["bucket"], j["probes"], fig2.THR, device="cpu")
        got = tuple(x.cpu() for x in j["scan"])
        assert_join_close(got, want, j["bucket"], j["probes"], fig2.THR)
    for r in rows:
        assert r["scan_device_part_us"] > 0 and r["indexed_device_part_us"] > 0
        assert r["scan_event_us"] > 0 and r["indexed_wall_us"] > 0
