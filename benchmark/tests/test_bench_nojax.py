"""No run loads JAX or the JAX package: the harness, every driver, reader,
count and reference, and the port's modules they call, imported in a
fresh process; the look for them catches a module by its whole top-level
name; and a run without a card, or without the port, prints no result."""

import os
import shutil
import subprocess
import sys

from bench_util import ROOT

IMPORT_ALL = """
import sys
sys.path.insert(0, {root!r})
from benchmark.lib import harness, training, roofline, compare, als_counts
for kind in ("drivers", "metrics", "counts"):
    for p in sorted((harness.HERE / kind).glob("*.py")):
        harness.load_module(kind, p.stem)
import benchmark.reference.mf_sgd, benchmark.reference.mf_als
import benchmark.gen.planted
import cu2rec_torch.train.trainer, cu2rec_torch.train.als
import cu2rec_torch.ops.cuda_sgd, cu2rec_torch.ops.cuda_loss
import cu2rec_torch.ops.cuda_gram, cu2rec_torch.ops.cuda_linalg
print(harness.forbidden_modules())
sys.exit(1 if harness.forbidden_modules() else 0)
"""


def _run(code, env=None, cwd=None):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=cwd)


def test_nothing_of_jax_is_loaded():
    out = _run(IMPORT_ALL.format(root=str(ROOT)))
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_look_compares_whole_top_level_names(tmp_path):
    for name in ("jax", "cu2rec_tpu", "jaxtyping_like", "cu2rec_tpu_x"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text("")
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
            "from benchmark.lib import harness\n"
            "import jaxtyping_like, cu2rec_tpu_x\n"
            "assert harness.forbidden_modules() == []\n"
            "import jax, cu2rec_tpu\n"
            "assert harness.forbidden_modules() == ['cu2rec_tpu', 'jax']\n"
            "try:\n"
            "    harness.assert_clean('now')\n"
            "except harness.Forbidden:\n"
            "    sys.exit(0)\n"
            "sys.exit(1)\n")
    out = _run(code)
    assert out.returncode == 0, out.stdout + out.stderr


def _bench_cmd(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ml20m-f50.sgd",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _bench_cmd(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench_cmd(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
