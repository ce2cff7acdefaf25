"""The benchmark of the PyTorch/CUDA port (``repro_torch``): closed-loop
decode cells on one H100, driven by ``BENCHMARK.json`` at the checkout's
root.  From that root:

    python3 -m liferaft_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); its correctness limits are in
``limits/<cell>.json`` and each per-layer metric is read by
``metrics/<metric>.py``.  ``reference/`` is plain PyTorch in float32 and
imports nothing of the port; ``control.py`` runs it in fp8, the control
the limits were set against.
"""
import pathlib

PACKAGE = pathlib.Path(__file__).resolve().parent
ROOT = PACKAGE.parent
