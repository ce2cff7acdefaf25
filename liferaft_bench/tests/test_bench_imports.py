"""The import check: what the harness and the reference load, compared by
whole top-level names (``repro_torch`` is the port, ``repro`` the JAX
package)."""
import subprocess
import sys

from liferaft_bench import ROOT, imports


def test_top_level_names_compare_whole():
    mods = {"repro_torch": 1, "repro_torch.models": 1, "reprox": 1,
            "jaxtyping": 1, "numpy": 1}
    assert imports.loaded(mods) == []
    mods.update({"repro.core": 1, "jax.numpy": 1, "flax": 1, "jaxlib": 1})
    assert imports.loaded(mods) == ["flax", "jax.numpy", "jaxlib", "repro.core"]


def test_reference_imports_nothing_of_the_port():
    assert imports.reference_violations() == []
    assert imports.reference_imports() <= {"torch", "dataclasses", "math",
                                           "typing", "__future__"}


def test_the_harness_loads_no_jax():
    """A fresh interpreter imports every module a run imports, and the
    port's decode path, and finds no forbidden name."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import liferaft_bench.run, liferaft_bench.serve, liferaft_bench.check\n"
        "import liferaft_bench.trace, liferaft_bench.control\n"
        "from liferaft_bench import manifest, imports\n"
        "m = manifest.load()\n"
        "[manifest.reader(p['name']) for p in m['per_layer']]\n"
        "import repro_torch.training.train_step, repro_torch.models.registry\n"
        "import repro_torch.models.moe\n"
        "print(imports.loaded())\n" % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_alone_loads_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import liferaft_bench.reference.decoder\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
