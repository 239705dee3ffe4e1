"""The harness's refusals: no card, no program, JAX loaded. None of them
prints a result."""

import json
import shutil
import subprocess
import sys

from portbench.harness import ROOT
from portbench.run import loaded_forbidden

RUN = ["portbench/run.py", "--workload", "tx50-mono2.kmers", "--seed", "2147483749",
       "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, *RUN], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_exits_non_zero_without_a_result():
    res = _run(ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode == 2, res.stderr
    assert res.stdout == "" and "CUDA card" in res.stderr


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


def test_unknown_cell_gives_no_result():
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "no-such.cell",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def test_forbidden_names_are_whole_top_level_names():
    before = dict(sys.modules)
    try:
        sys.modules["mazu_tpu_torch.x"] = sys.modules[__name__]
        sys.modules["jaxtyping_like"] = sys.modules[__name__]
        assert loaded_forbidden() == []
        sys.modules["mazu_tpu.index"] = sys.modules[__name__]
        sys.modules["jaxlib"] = sys.modules[__name__]
        assert loaded_forbidden() == ["jaxlib", "mazu_tpu"]
    finally:
        for key in set(sys.modules) - set(before):
            del sys.modules[key]


_PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
sys.modules["jax"] = None  # an import of jax now fails
from portbench.harness import run_cell
from portbench.run import loaded_forbidden
from portbench.tests.small import CELLS, small_spec
from portbench import control
for cell in CELLS:
    assert run_cell(small_spec(cell), 5, 0.2, True, "cpu")["correct"]
    control.control_wrong(small_spec(cell), 5, "cpu")
del sys.modules["jax"]
mods = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"forbidden": loaded_forbidden(), "modules": mods}))
"""


def test_no_module_the_harness_loads_is_jax_or_the_jax_package():
    res = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "mazu_tpu"} & set(out["modules"])
    assert {"mazu_tpu_torch", "portbench", "torch"} <= set(out["modules"])
