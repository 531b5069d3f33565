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
    [*PORT.rglob("*.py"), *PORT.rglob("*.cu"), REPO / "chip_smoke.py"]))
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
    from cu2rec_torch.cli.serve import build_parser
    from cu2rec_torch.models.state import init_model
    from cu2rec_torch.serve.engine import ServingEngine

    assert build_parser().parse_args([]).device == "cuda"
    model = init_model(3, 4, 2, 3.0, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(3, 4, 2, 3.0)


def test_port_builds_nothing_at_import():
    """Importing the kernel modules neither runs nvcc nor creates the build
    directory's libraries (the kernels build at first launch)."""
    env = {k: v for k, v in os.environ.items()}
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import subprocess\n"
        "def boom(*a, **k): raise SystemExit('subprocess at import')\n"
        "subprocess.Popen = boom; subprocess.run = boom\n"
        "import cu2rec_torch.ops.cuda_linalg, cu2rec_torch.csrc.build\n"
        "import cu2rec_torch.ops.als, cu2rec_torch.ops.ials\n"
        "print('NO_BUILD_AT_IMPORT')\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert "NO_BUILD_AT_IMPORT" in out.stdout, out.stdout + out.stderr
