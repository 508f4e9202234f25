"""The port stands alone: it imports no JAX and nothing of the JAX package,
and its entry points do not quietly run on the CPU when no card is present."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_OF_REPRO = re.compile(r"^\s*(from|import)\s+repro(\.|\s|$)", re.MULTILINE)


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch, repro_torch.serving.engine, repro_torch.launch.serve\n"
            "import repro_torch.kernels.ops, repro_torch.models.bridge\n"
            "import repro_torch.models.rglru, repro_torch.kernels.rglru_scan\n"
            "import repro_torch.configs.recurrentgemma_9b\n"
            "import repro_torch.serving.graphs, repro_torch.utils.prng\n"
            "import repro_torch.serving.speculative, repro_torch.configs.qwen1_5_4b\n"
            "import repro_torch.api, repro_torch.core, repro_torch.serving.online\n"
            "import repro_torch.serving.pool, repro_torch.serving.tinypool\n"
            "import repro_torch.serving.semcache, repro_torch.training.optimizer\n"
            "import repro_torch.data, repro_torch.kernels.launches\n"
            "import repro_torch.training.train_loop, repro_torch.checkpoint\n"
            "import repro_torch.data.pipeline, repro_torch.utils.tree\n"
            "import repro_torch.launch.train, repro_torch.http\n"
            "import repro_torch.http.server, repro_torch.http.protocol\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_never_import_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if IMPORT_OF_REPRO.search(f.read_text()) or "import jax" in f.read_text()]
    assert not offenders


def test_entry_points_default_to_the_card():
    from repro_torch.config import get_arch
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import ServingEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_arch("tiny-s"))
    model = Model(get_arch("tiny-s"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model)
