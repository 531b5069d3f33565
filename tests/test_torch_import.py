"""The PyTorch port stands alone: every module imports with JAX blocked, no
source file of the port names JAX or the TPU package, and the default
device is CUDA with no silent fall-back to the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (both packages are imported by the port's tests)
import numpy as np  # noqa: F401
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cu2rec_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert "cu2rec_torch.serve.engine" in mods
    assert "cu2rec_torch.parallel.serving" in mods
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        "for m in %r:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'cu2rec_tpu' or k.startswith('cu2rec_tpu.')\n"
        "               for k in sys.modules)\n"
        "print('PORT_IMPORTS_OK')\n" % (str(REPO), mods))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, cwd=str(REPO))
    assert "PORT_IMPORTS_OK" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*PORT.rglob("*.py"), *PORT.rglob("*.cu"), *PORT.rglob("*.cpp"),
     REPO / "chip_smoke.py"]))
def test_port_sources_name_neither_jax_nor_tpu_package(path):
    text = (REPO / path).read_text()
    assert not re.search(r"\bjax\b", text, re.IGNORECASE), path
    assert "cu2rec_tpu" not in text, path


def test_resolve_device_default_is_cuda_without_fallback():
    from cu2rec_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_default_to_cuda():
    """The engine and the CLI take the CUDA device unless the CPU is asked
    for: without a card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from cu2rec_torch.cli import evaluate, mf, predict
    from cu2rec_torch.cli.serve import build_parser
    from cu2rec_torch.data.csr import csr_from_arrays
    from cu2rec_torch.models.state import init_model
    from cu2rec_torch.serve.engine import ServingEngine, ShardedServingEngine
    from cu2rec_torch.train.trainer import SingleChipEngine
    from cu2rec_torch.utils.config import Config

    assert build_parser().parse_args([]).device == "cuda"
    assert mf.build_parser().parse_args(["a.csv", "b.csv"]).device == "cuda"
    assert predict.build_parser().parse_args(
        ["-c", "c", "-i", "i", "-g", "g", "-q", "q", "u.csv"]).device == \
        "cuda"
    assert evaluate.build_parser().parse_args(["t.csv"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--checkpoint", "m.npz", "t.csv"])
    model = init_model(3, 4, 2, 3.0, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedServingEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(3, 4, 2, 3.0)
    csr = csr_from_arrays(np.array([0, 1]), np.array([1, 2]),
                          np.array([4.0, 3.0], np.float32), 3, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SingleChipEngine(csr, csr, Config(n_factors=2))
    assert SingleChipEngine(csr, csr, Config(n_factors=2),
                            device="cpu").device == torch.device("cpu")


def test_port_builds_nothing_at_import():
    """Importing the kernel modules, the native host library's bindings and
    the CLIs runs no compiler, nvcc or g++ (the kernels build at first
    launch, the host library at first use)."""
    env = {k: v for k, v in os.environ.items()}
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import subprocess\n"
        "def boom(*a, **k): raise SystemExit('subprocess at import')\n"
        "subprocess.Popen = boom; subprocess.run = boom\n"
        "import cu2rec_torch.ops.cuda_linalg, cu2rec_torch.csrc.build\n"
        "import cu2rec_torch.ops.cuda_sgd, cu2rec_torch.ops.cuda_loss\n"
        "import cu2rec_torch.ops.cuda_gather, cu2rec_torch.cli.mf\n"
        "import cu2rec_torch.ops.als, cu2rec_torch.ops.ials\n"
        "import cu2rec_torch.ops.cuda_gram\n"
        "import cu2rec_torch.data.native, cu2rec_torch.data.mapping\n"
        "from cu2rec_torch.cli import (convert_to_np, create_config,\n"
        "    evaluate, get_data, map_items, map_netflix, mf_cpu,\n"
        "    sort_ratings, split, synth)\n"
        "from cu2rec_torch.data import native\n"
        "assert native._LIB is None and native.CALLS == 0\n"
        "print('NO_BUILD_AT_IMPORT')\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert "NO_BUILD_AT_IMPORT" in out.stdout, out.stdout + out.stderr


# Each subpackage of the TPU package and its counterpart in the port.
SUBPACKAGES = ["", ".data", ".models", ".ops", ".serve", ".train", ".utils"]


@pytest.mark.parametrize("sub", SUBPACKAGES + [".__all__"])
def test_port_exports_every_public_name_of_the_tpu_package(sub):
    """Every name in the ``__all__`` of a TPU-package subpackage (and of the
    package itself) resolves in the port's counterpart; the last case
    imports the port's top-level names in a process with JAX blocked,
    where they load lazily and build nothing."""
    import importlib

    if sub == ".__all__":
        import cu2rec_tpu

        code = (
            "import sys; sys.path.insert(0, %r)\n"
            "sys.modules['jax'] = None\n"
            "import subprocess\n"
            "def boom(*a, **k): raise SystemExit('subprocess at import')\n"
            "subprocess.Popen = boom; subprocess.run = boom\n"
            "import cu2rec_torch\n"
            "assert 'cu2rec_torch.train' not in sys.modules\n"
            "from cu2rec_torch import *\n"
            "for name in %r: getattr(cu2rec_torch, name)\n"
            "print('TOP_LEVEL_OK')\n" % (str(REPO), cu2rec_tpu.__all__))
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120)
        assert "TOP_LEVEL_OK" in out.stdout, out.stdout + out.stderr
        return
    tpu = importlib.import_module("cu2rec_tpu" + sub)
    port = importlib.import_module("cu2rec_torch" + sub)
    missing = [n for n in tpu.__all__ if not hasattr(port, n)]
    assert not missing, f"cu2rec_torch{sub} lacks {missing}"
    assert set(tpu.__all__) <= set(port.__all__)


def test_initialize_normal_draws_its_mean_and_deviation():
    """Normal(mean, stddev / n_factors) from a seeded generator, as the TPU
    package's ``initialize_normal`` (the bits differ: threefry is not
    torch's generator), cast to the table dtype on the device asked for;
    the same seed gives the same draw."""
    from cu2rec_torch.models import initialize_normal

    gen = torch.Generator().manual_seed(3)
    x = initialize_normal(gen, (400, 250), 20, mean=0.5, stddev=2.0,
                          device="cpu")
    assert x.shape == (400, 250) and x.dtype == torch.float32
    assert abs(float(x.mean()) - 0.5) < 4 * 0.1 / 1e5 ** 0.5
    assert abs(float(x.std()) - 0.1) < 0.1 * 0.01
    again = initialize_normal(torch.Generator().manual_seed(3), (400, 250),
                              20, mean=0.5, stddev=2.0, device="cpu")
    assert torch.equal(x, again)
    half = initialize_normal(gen, (8,), 4, dtype=torch.bfloat16,
                             device="cpu")
    assert half.dtype == torch.bfloat16
