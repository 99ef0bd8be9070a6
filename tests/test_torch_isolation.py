"""The PyTorch port stands alone: no JAX and no JAX package at import or in
its source, the card by default, and no silent fallback from a kernel."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "spark_rapids_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "spark_rapids_tpu"
            or module.startswith("spark_rapids_tpu."))


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = ("import sys, spark_rapids_tpu_torch, "
            "spark_rapids_tpu_torch.models.tpch, "
            "spark_rapids_tpu_torch.cpu.exec; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'spark_rapids_tpu.')) "
            "or m == 'spark_rapids_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_session_defaults_to_cuda_and_raises_without_it():
    import spark_rapids_tpu_torch as srt
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default session is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        srt.Session.get_or_create()
    with pytest.raises(RuntimeError, match="CUDA"):
        srt.Session(device="cuda")
    assert srt.Session(device="cpu").device == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: given CPU tensors they do not
    run the plain version."""
    from spark_rapids_tpu_torch.ops import groupby
    active = torch.ones(4, dtype=torch.bool)
    acc_f, acc_i = groupby.init_scalars([("sum", True)],
                                        torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        groupby.masked_reduce([(torch.ones(4, dtype=torch.float64), None,
                                "sum")], active, acc_f, acc_i)
    keys = [(torch.zeros(4, dtype=torch.int32), None)]
    with pytest.raises(ValueError, match="CUDA"):
        groupby.grid_agg(keys, (1,), [], [], active,
                         torch.zeros((2, 0), dtype=torch.float64),
                         torch.zeros((2, 0), dtype=torch.int64),
                         torch.zeros(2, dtype=torch.int64))
    assert groupby.masked_reduce.launches == 0
    assert groupby.grid_agg.launches == 0


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    from spark_rapids_tpu_torch import kernels
    # a compiler that rejects every flag stands in for a failing nvcc
    monkeypatch.setattr(kernels, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        kernels.build(["masked_reduce"])
    assert not list(tmp_path.glob("*.so"))


def _host_forbidden(module: str) -> bool:
    return module.split(".")[0] in ("pyarrow", "pandas")


def test_import_pulls_in_no_pyarrow_or_pandas():
    """The card's machine has neither: the port, its parquet reader and
    writer included, imports neither."""
    code = ("import sys, spark_rapids_tpu_torch, "
            "spark_rapids_tpu_torch.models.tpch, "
            "spark_rapids_tpu_torch.io.parquet, "
            "spark_rapids_tpu_torch.io.writers, "
            "spark_rapids_tpu_torch.io.filecache, "
            "spark_rapids_tpu_torch.io.sources, "
            "spark_rapids_tpu_torch.plan.join_exec, "
            "spark_rapids_tpu_torch.cpu.exec; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('pyarrow', 'pandas')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_pyarrow_or_pandas(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _host_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _host_forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_key_stats_kernel_refuses_cpu_tensors():
    from spark_rapids_tpu_torch.ops import runtime_filter
    with pytest.raises(ValueError, match="CUDA"):
        runtime_filter.key_stats_kernel(torch.arange(4), None, None, 1024)
