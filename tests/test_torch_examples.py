"""The port's single-card examples (``examples/torch_*.py``) and serving
launcher (``python -m repro_torch.launch.serve``) on the CPU
(``--device cpu``), against the JAX package's examples and launcher: the
quickstart's whole output, the pruning example's lines but its times
(the DTPU keep plan, the savings, each mode's kept counts), the serving
example's planner line and counts, and the launcher's requests and token
counts are the JAX ones.  Without a card and without ``--device cpu``
every one of them refuses to start."""
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import serve as jlaunch
from repro_torch.launch import serve as launch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "crossmodal_pruning", "serve_batch")


def _port(name):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_port(name, capsys):
    _port(name).main(["--device", "cpu"])
    return capsys.readouterr().out.splitlines()


def _run_jax(name, capsys):
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                   run_name="__main__")
    return capsys.readouterr().out.splitlines()


def test_quickstart_prints_the_jax_example_lines(capsys):
    """Every line, the three modes' agreement in f32 within 1e-4 (the
    example asserts it), the HBM MiB per mode and the plan_model lines."""
    got = _run_port("quickstart", capsys)
    assert got == _run_jax("quickstart", capsys)
    assert "all three execution systems agree (allclose) ✓" in got
    assert any(line.strip().startswith("tile_stream") and "MiB" in line
               for line in got)


def test_crossmodal_pruning_prints_the_jax_example_lines(capsys):
    """The DTPU keep plan, the compute retained and each mode's logits
    shape and kept counts per block; only the times differ."""
    strip = lambda lines: [re.sub(r"\s+[0-9.]+ ms$", "", ln) for ln in lines]
    got = _run_port("crossmodal_pruning", capsys)
    want = _run_jax("crossmodal_pruning", capsys)
    assert strip(got) == strip(want)
    assert got[0] == "DTPU keep plan over 4 co-TRM blocks: " \
                     "256 -> 256 -> 128 -> 128 -> 76"
    assert sum(" ms" in ln for ln in got) == 3


def test_serve_batch_matches_the_jax_example(capsys):
    """The planner line equal; the served line's requests, tokens, steps,
    decode calls and peak concurrency equal (the tokens themselves come
    from other weights: seed 0 of a torch generator)."""
    counts = lambda ln: re.sub(r" in [0-9.]+s \([0-9.]+ tok/s on \w+\)", "",
                               ln)
    got = _run_port("serve_batch", capsys)
    want = _run_jax("serve_batch", capsys)
    assert got[0] == want[0]
    assert counts(got[1]) == counts(want[1])
    assert "on CPU" in got[1]
    assert [ln.split("->")[0] for ln in got[2:]] == \
        [ln.split("->")[0] for ln in want[2:]]


def test_launcher_serves_the_jax_launchers_requests(capsys, monkeypatch):
    """The same drawn requests (np.random.default_rng(0)) and the same
    request and token counts as ``python -m repro.launch.serve --smoke``."""
    argv = ["--arch", "starcoder2-7b", "--smoke", "--requests", "3",
            "--max-new", "4", "--max-len", "64"]
    submitted = []

    class Recording(jlaunch.Engine):
        def submit(self, req):
            submitted.append((req.rid, np.asarray(req.prompt).tolist(),
                              req.max_new_tokens))
            super().submit(req)

    monkeypatch.setattr(jlaunch, "Engine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jlaunch.main()
    want = capsys.readouterr().out
    launch.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    head = lambda s: s.split(",")[:2]
    assert head(got) == head(want) == ["3 requests", " 12 new tokens"]
    args = launch.parse(argv + ["--device", "cpu"])
    eng, done = launch.run(args)
    drawn = launch.draw_requests(eng.cfg, 3, 64, 4)
    assert [(r.rid, r.prompt.tolist(), r.max_new_tokens)
            for r in drawn] == submitted
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 4 for r in done)
    assert eng.model.device.type == "cpu"


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_refuse_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name).main([])


def test_launcher_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "starcoder2-7b", "--smoke"])
    with pytest.raises(NotImplementedError, match="models.encdec"):
        launch.main(["--arch", "whisper-base", "--smoke", "--device",
                     "cpu"])
