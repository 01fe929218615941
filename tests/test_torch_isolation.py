"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

Importing every module of ``repro_torch`` and ``chip_smoke.py`` in a
fresh interpreter leaves ``jax`` and ``repro`` out of ``sys.modules``;
the entry points raise on a machine without a card unless the caller
asks for the CPU.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_no_jax_and_no_reference_imports():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 25
    assert bad.strip() == "[]", bad


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.analysis import lint
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    from repro_torch.serving import ServeEngine
    cfg = get_config("qwen3_8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3_8b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        lint.run_lint(cfg, "qwen3_8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        lint.main(["--arch", "qwen3_8b"])


@pytest.mark.parametrize("arch", ["phi3_medium_14b", "stablelm_12b",
                                  "granite_34b", "arctic_480b",
                                  "paper_native"])
def test_zoo_configs_raise_without_a_card(arch):
    """The five zoo configs' entry points, at full width, refuse the CPU
    unless asked, before any weight is drawn: the launcher, and the
    engine with and without the packed init."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serving import ServeEngine
    cfg = get_config(arch)
    for pack in (False, True):
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(cfg, pack_weights=pack)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", arch, "--pack-weights"])


def test_cpu_serving_when_asked():
    """The launcher drains on the CPU when asked to (plain versions)."""
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3_8b", "--reduced", "--pack-weights",
                "--device", "cpu", "--requests", "3", "--max-new-tokens",
                "2", "--slots", "2"])


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line without a
    card, and also when only the script is present."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
