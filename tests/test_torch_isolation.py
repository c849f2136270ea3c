"""The port stands alone: it imports without JAX and without the JAX
package, its sources name neither, and its entry points default to CUDA
and raise, rather than fall back to the CPU, when there is none."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"

MODULES = ["repro_torch", "repro_torch.configs", "repro_torch.interop",
           "repro_torch.tree",
           "repro_torch.kernels", "repro_torch.kernels._build",
           "repro_torch.kernels.prng", "repro_torch.kernels.sampling",
           "repro_torch.kernels.fused_update",
           "repro_torch.models.layers", "repro_torch.models.attention",
           "repro_torch.models.transformer", "repro_torch.models.model",
           "repro_torch.serve", "repro_torch.serve.engine",
           "repro_torch.optim.sgd", "repro_torch.optim.schedules",
           "repro_torch.core", "repro_torch.core.autodiff",
           "repro_torch.core.topology", "repro_torch.core.virtual",
           "repro_torch.core.sync", "repro_torch.core.trainer",
           "repro_torch.data.pipeline", "repro_torch.launch.train",
           "repro_torch.launch.profile_train"]


def test_port_imports_with_jax_and_repro_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "from repro_torch.configs import get_config\n"
            "get_config('qwen2-1.5b')\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_sources_name_neither_jax_nor_repro(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"^\s*(from\s+repro\.|import\s+repro\b|"
                         r"from\s+repro\s+import)", text, re.M)


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import build_model
    from repro_torch.serve import Engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(smoke_variant(get_config("qwen2-1.5b")))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(model, {})


def test_trainer_entry_point_raises_when_cuda_is_absent(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])
