"""The port's launchers on the CPU: ``python -m repro_torch.launch.train``
and ``.serve`` with ``--device cpu`` run the smoke configs and print the
reference's lines; without ``--device`` they ask for the card, and raise
where there is none."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(module: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{module}", *args],
                       capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_launch_train_smoke_on_the_cpu(tmp_path):
    out = _launch("train", "--arch", "llama3_8b", "--smoke", "--steps", "4",
                  "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"))
    m = re.search(r"\[train\] done: final loss ([0-9.]+), mean step (\d+) ms", out)
    assert m, out
    assert float(m.group(1)) > 0
    assert os.path.isdir(tmp_path / "ckpt" / "step_00000004")


def test_launch_serve_smoke_on_the_cpu():
    out = _launch("serve", "--arch", "llama3_8b", "--smoke", "--device", "cpu")
    m = re.search(r"\[serve\] (\d+) requests done; mean completion [0-9.]+ ticks "
                  r"\(p95 \d+\); locality \[[0-9., ]+\]; probes/decision ([0-9.]+) \(pod\)", out)
    assert m, out
    assert int(m.group(1)) == 32 and float(m.group(2)) == 11.0


@pytest.mark.parametrize("module", ["train", "serve"])
def test_launchers_default_to_the_card(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{module}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--arch", "llama3_8b", "--smoke", "--steps", "1",
                  "--ckpt-dir", str(tmp_path)] if module == "train" else
                 ["--arch", "llama3_8b", "--smoke"])
