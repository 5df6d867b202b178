"""Guards on the port's boundaries.

* No file of ``src/repro_torch/`` nor ``chip_smoke.py`` imports ``jax`` or
  the JAX package ``repro`` (the port keeps its own copies).
* ``repro_torch`` imports with ``jax`` and ``repro`` blocked.
* Entry points run on the GPU unless asked for the CPU: without a GPU they
  raise instead of silently falling back.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_sources_never_import_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not offenders, offenders


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.bridge, repro_torch.configs\n"
            "import repro_torch.core, repro_torch.kernels, repro_torch.obs\n"
            "import repro_torch.models, repro_torch.serve\n"
            "assert not any(m == 'jax' or m.startswith('jax.') for m in "
            "sys.modules if sys.modules[m] is not None)\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_default_to_the_gpu():
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_lm, materialize
    from repro_torch.serve import Scheduler, init_cache
    from repro_torch.bridge import params_from_jax

    cfg = get_smoke("qwen2_1_5b")
    if torch.cuda.is_available():
        params = materialize(0, init_lm(cfg))
        assert params["embed"]["tok"].device.type == "cuda"
        assert Scheduler(cfg, params).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        materialize(0, init_lm(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
    params = materialize(0, init_lm(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"stacks": [{}]}, cfg)
    # asking for the CPU works
    assert Scheduler(cfg, params, device="cpu").device.type == "cpu"
