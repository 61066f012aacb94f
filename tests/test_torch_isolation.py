"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` load neither
JAX nor the JAX package, and every entry point refuses to run on a machine
without a GPU unless the caller asks for the CPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("FORBIDDEN", bad)
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_imports_load_neither_jax_nor_repro():
    code = _IMPORT_ALL.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout
    assert int(re.search(r"LOADED (\d+)", out.stdout).group(1)) >= 20


def test_sources_name_no_jax_and_no_reference_module():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits, hits


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")


def test_entry_points_raise_without_gpu(no_cuda):
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import LM, build_model
    from repro_torch.serve import Engine
    cfg = configs.get("smollm-135m").reduced()
    for make in (lambda: build_model(cfg), lambda: LM(cfg),
                 lambda: build_model(cfg, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, params)
    Engine(model, params, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-135m", "--reduced"])
    reqs = serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                       "--requests", "2", "--max-new", "2"])
    assert [len(r.output) for r in reqs] == [2, 2]


def test_kernel_build_raises_without_nvcc(no_cuda):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed")
    from repro_torch.kernels import build
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("blast_matmul")


def test_chip_smoke_fails_without_gpu_or_sources(no_cuda, tmp_path):
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                           capture_output=True, text=True, timeout=120,
                           env=_env())]
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"],
                               cwd=tmp_path, capture_output=True, text=True,
                               timeout=120, env=_env()))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
