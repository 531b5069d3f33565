"""The gather probes' kernels K2 and K3 (``ops/cuda_gather.py``): their plain
versions against the repository's Pallas probes run in interpret mode on
the CPU, exactly, and the wrappers' refusals, which are the same on every
device."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.ops import cuda_gather as cg

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _probe(monkeypatch, name):
    """Import ``experiments/<name>.py`` with the compile cache left off
    (importing the on-chip probe otherwise turns on the persistent cache
    for the whole test process)."""
    monkeypatch.setenv("CU2REC_NO_COMPILE_CACHE", "1")
    spec = importlib.util.spec_from_file_location(
        f"probe_{name}", ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(I, W, M, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(I, W)).astype(np.float32)
    idx = rng.integers(0, I, M).astype(np.int32)
    return table, idx


def test_row_gather_reference_equals_the_pallas_kernel(monkeypatch):
    probe = _probe(monkeypatch, "gather_roofline")
    table, idx = _inputs(300, 128, 40, seed=0)
    want = np.asarray(probe._pallas_row_gather(
        jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = cg.row_gather_reference(torch.from_numpy(table),
                                  torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_smem_gather_reference_equals_the_pallas_kernel(monkeypatch):
    probe = _probe(monkeypatch, "vmem_gather_probe")
    table, idx = _inputs(448, 128, 2048, seed=1)
    want = np.asarray(probe.vmem_gather(jnp.asarray(table), jnp.asarray(idx),
                                        interpret=True))
    got = cg.smem_gather_reference(torch.from_numpy(table),
                                   torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", [cg.row_gather, cg.smem_gather])
def test_wrappers_run_the_plain_version_on_the_cpu(fn):
    table, idx = _inputs(100, 32, 77, seed=2)
    n0 = fn.LAUNCHES
    got = fn(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), table[idx])
    assert fn.LAUNCHES == n0


@pytest.mark.parametrize("fn", [cg.row_gather, cg.smem_gather])
def test_plain_version_raises_on_an_index_past_the_table(fn):
    """On the CPU an index of I or more raises, as ``table[idx]`` does; on
    the card the kernels give a row of NaN instead (``tests/test_torch_gpu``)
    and read nothing outside the table."""
    table, idx = _inputs(50, 32, 9, seed=3)
    idx[4] = 50
    with pytest.raises(IndexError):
        fn(torch.from_numpy(table), torch.from_numpy(idx))


def test_smem_gather_refuses_a_table_over_shared_memory():
    fits = torch.zeros((cg.SMEM_LIMIT_BYTES // 512, 128))
    idx = torch.zeros(4, dtype=torch.int32)
    assert cg.smem_gather(fits, idx).shape == (4, 128)
    too_big = torch.zeros((fits.shape[0] + 1, 128))
    with pytest.raises(cg.TableTooLarge, match="does not fit"):
        cg.smem_gather(too_big, idx)


@pytest.mark.parametrize("fn", [cg.row_gather, cg.smem_gather])
@pytest.mark.parametrize("W", [3, 6, 130])
def test_rows_must_be_16_byte_multiples(fn, W):
    with pytest.raises(ValueError, match="16-byte"):
        fn(torch.zeros((8, W)), torch.zeros(2, dtype=torch.int32))


def test_row_gather_refuses_rows_over_its_ring_stage():
    with pytest.raises(ValueError, match="ring"):
        cg.row_gather(torch.zeros((8, 516)),
                      torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("fn", [cg.row_gather, cg.smem_gather])
def test_wrappers_check_types(fn):
    with pytest.raises(TypeError):
        fn(torch.zeros((8, 4), dtype=torch.float64),
           torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        fn(torch.zeros((8, 4)), torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("name", ["gather_roofline", "vmem_gather_probe"])
def test_probes_need_the_card(name):
    """The ported probes measure the card: without one they raise, and
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"cu2rec_torch.experiments.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def _def_line(fn) -> int:
    """The line of ``fn``'s ``def`` (after any decorators)."""
    import inspect

    lines, first = inspect.getsourcelines(getattr(fn, "__wrapped__", fn))
    return first + next(n for n, ln in enumerate(lines)
                        if ln.lstrip().startswith("def "))


@pytest.mark.parametrize("rel,needle,where", [
    ("ops/packed.py", "def packed_step(", ("cu2rec_tpu.ops.packed",
                                           "packed_step")),
    ("ops/loss.py", "def _eval_packed_jit", ("cu2rec_tpu.ops.loss",
                                             "_eval_packed_jit")),
    ("gather_roofline.py", "def _pallas_row_gather",
     ("gather_roofline", "_pallas_row_gather")),
    ("vmem_gather_probe.py", "def vmem_gather",
     ("vmem_gather_probe", "vmem_gather"))])
def test_smoke_names_the_tpu_code_of_each_kernel(monkeypatch, rel, needle,
                                                 where):
    """chip_smoke.py's kernels line names, for K0a and K0b, the TPU code
    whose semantics they take and, for K2 and K3, the Pallas kernel they
    replace, by the file and line of its definition."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mod, name = where
    if mod.startswith("cu2rec_tpu"):
        module = importlib.import_module(mod)
        path = mod.replace(".", "/") + ".py"
    else:
        module = _probe(monkeypatch, mod)
        path = f"experiments/{mod}.py"
    line = _def_line(getattr(module, name))
    assert smoke._tpu_kernel_site(rel, needle) == f"{path}:{line}"


def test_smoke_reads_the_register_report_of_each_kernel():
    """chip_smoke.py turns an ``-Xptxas -v`` build log into one row per
    entry function: its name as ``kernel<template arguments>``, its
    registers a thread, spilled bytes and static shared bytes."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    log = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115sgd_item_kernelILi128ELi0EEEvNS_4StepE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115sgd_item_kernelILi128ELi0EEEvNS_4StepE
    16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 132 bytes smem, 552 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118eval_finish_kernelEPKdiPd' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118eval_finish_kernelEPKdiPd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 4096 bytes smem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__3b16e78f_14_smem_gather_cu_b7067f9318smem_gather_kernelEPK6float4PKiPS0_xii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__cde82dc2_17_ridge_cholesky_cu_bb6c8ca019ridge_bucket_kernelILi8ELi16ELi1EEEvPKfS2_Pfii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 207 registers, used 1 barriers, 33536 bytes smem
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__cde82dc2_17_ridge_cholesky_cu_bb6c8ca021ridge_cholesky_kernelILb1EEEvPKfS2_PfS3_i' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
"""
    assert smoke._ptxas_report(log) == [
        ("sgd_item_kernel<128,0>", 40, 12, 132),
        ("eval_finish_kernel", 32, 0, 4096),
        ("smem_gather_kernel", 46, 0, 0),
        ("ridge_bucket_kernel<8,16,1>", 207, 0, 33536),
        ("ridge_cholesky_kernel<1>", 32, 0, 0)]
    assert smoke._ptxas_report("nvcc: no report\n") == []
