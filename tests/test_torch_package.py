"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and nothing runs on the CPU unless the
caller asks for it."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.convert import vilbert_from_jax
from repro_torch.core import runtime
from repro_torch.models.transformer import Transformer
from repro_torch.models.vilbert import ViLBERT
from repro_torch.serve.kv_cache import PagedKVCache

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _python(*args, cwd=ROOT, pythonpath=str(ROOT / "src")):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    if pythonpath:
        env["PYTHONPATH"] = pythonpath
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_no_jax_and_no_repro_module():
    code = (
        "import sys\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "import repro_torch.convert, repro_torch.kernels.ops\n"
        "import repro_torch.serve.engine, repro_torch.models.transformer\n"
        "import repro_torch.plan, repro_torch.models.mla\n"
        "import repro_torch.configs.grok1_314b\n"
        "import repro_torch.configs.deepseek_v3_671b\n"
        "import repro_torch.sim, repro_torch.sim.replay\n"
        "import repro_torch.configs.minitron_4b\n"
        "import repro_torch.configs.h2o_danube3_4b\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    res = _python("-c", code)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


def test_no_source_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|"
                         r"from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)
    files = list(PKG.rglob("*.py")) + sorted(ROOT.glob("chip_*.py"))
    assert len(files) > 15
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_entry_points_raise_without_a_gpu_or_a_named_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = get_config("vilbert-base", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViLBERT(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vilbert_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(get_config("qwen3-32b", smoke=True))
    for arch in ("grok-1-314b", "deepseek-v3-671b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Transformer(get_config(arch, smoke=True))
    assert runtime.resolve_device("cpu").type == "cpu"


def test_paged_pool_raises_without_a_gpu_or_a_named_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    kw = dict(slots=2, num_layers=1, kv_heads=1, width=8, head_dim=4,
              dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(**kw)
    assert PagedKVCache(device="cpu", **kw)._k_pool.device.type == "cpu"


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """No card: a non-zero exit and no result line.  A directory holding
    chip_smoke.py and nothing else of the repo: the same."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _python(str(ROOT / "chip_smoke.py"))
    assert res.returncode != 0 and '"ok"' not in res.stdout
    assert "no CUDA device" in res.stderr
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = _python(str(alone), cwd=tmp_path, pythonpath=None)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_training_modules_import_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch.train.loop, repro_torch.train.checkpoint\n"
        "import repro_torch.launch.train, repro_torch.data.pipeline\n"
        "import repro_torch.kernels.flash_vjp\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    res = _python("-c", code)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


def test_serving_obs_and_examples_import_no_jax_and_no_repro():
    """The launcher, the obs CLI, the serving simulator, the int8 path and
    the three single-card examples (imported from their files)."""
    code = (
        "import importlib.util, sys\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "import repro_torch.obs.__main__, repro_torch.launch.serve\n"
        "import repro_torch.sim.serve_sim, repro_torch.kernels.quant\n"
        "import repro_torch.core.streaming, repro_torch.obs.whatif\n"
        "for name in ('quickstart', 'crossmodal_pruning', 'serve_batch'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'examples/torch_{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    res = _python("-c", code)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|"
                         r"from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)
    files = sorted(ROOT.glob("examples/torch_*.py"))
    assert len(files) == 3
    assert not [str(f) for f in files if pattern.search(f.read_text())]


def test_training_entry_points_raise_without_a_gpu_or_a_named_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core.types import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as launcher
    from repro_torch.train import loop
    cfg = get_config("qwen3-32b", smoke=True)
    shape = ShapeConfig("t", 8, 2, "train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(cfg, shape, SyntheticLM(cfg, shape),
                   loop.TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "qwen3-32b", "--smoke", "--steps", "1"])


def _decode_inputs():
    from repro_torch.kernels.decode_attention import decode_attention
    q = torch.randn(1, 2, 1, 8, requires_grad=True)
    kv = torch.randn(1, 1, 4, 8)
    return lambda: decode_attention(q, kv, kv, 4)


def _ssd_inputs():
    from repro_torch.kernels.ssd_scan import ssd_scan
    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    return lambda: ssd_scan(x, torch.rand(1, 8, 2), -torch.rand(2),
                            torch.randn(1, 8, 4), torch.randn(1, 8, 4),
                            chunk=4)


def test_kernels_without_a_backward_raise_under_grad():
    """No detached result: decode attention, on no training path, raises
    for an input that requires grad; under no_grad the same call runs."""
    call = _decode_inputs()
    with pytest.raises(NotImplementedError, match="no training path"):
        call()
    with torch.no_grad():
        call()


def test_ssd_scan_under_grad_records_its_backward():
    """The SSD scan under autograd goes through SSDScanFn (no detached
    result); under no_grad it records nothing."""
    call = _ssd_inputs()
    y, _ = call()
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
    with torch.no_grad():
        assert call()[0].grad_fn is None
