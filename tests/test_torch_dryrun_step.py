"""The dry run on a one-device fake mesh against a real step on the CPU:
argument bytes and FLOPs (``launch.dryrun.trace_cell``), in a process of
its own."""
import json
import os
import subprocess
import sys

_AGAINST_A_STEP = r"""
import json, os, sys
os.environ["REPRO_TEST_MESH"] = "1x1"
sys.path.insert(0, "src")
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import PipelineConfig, SyntheticLM
from repro_torch.launch import dryrun as D, specs as S
from repro_torch.models.sharding import use_mesh
from repro_torch.train import init_train_state, train_step
cfg = get("llama3_8b", smoke=True).replace(train_microbatches=1, n_layers=3)
shape = ShapeSpec("cell", 64, 4, "train")
D.fake_world(1)
mesh = D.make_production_mesh()
S.rules_for(cfg, shape, mesh)
with use_mesh(mesh):
    rec = D.trace_cell(cfg, shape, mesh)
ocfg = S.opt_config_for(cfg)
state = init_train_state(cfg, ocfg, 0, device="cpu")
batch = SyntheticLM(PipelineConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)).next_batch()
real = D.local_bytes(state) + sum(v.nbytes for v in batch.values())
with FlopCounterMode(display=False) as fc:
    train_step(state, batch, cfg=cfg, opt_cfg=ocfg, microbatches=1)
print("AGAINST " + json.dumps([rec["memory"]["argument_size_in_bytes"], real,
                               rec["cost"]["flops"], fc.get_total_flops()]))
"""


def test_dryrun_one_device_equals_a_real_step():
    """On a one-device fake mesh the dry run's argument bytes are the real
    state's and batch's, and its FLOPs (traced at one and two layers and
    taken to three) are FlopCounterMode's count of a real three-layer
    step."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _AGAINST_A_STEP], capture_output=True,
                       text=True, timeout=120, cwd=root)
    lines = [l for l in r.stdout.splitlines() if l.startswith("AGAINST ")]
    assert r.returncode == 0 and lines, r.stderr[-3000:]
    arg, real, flops, counted = json.loads(lines[-1][len("AGAINST "):])
    assert arg == real
    assert flops == counted > 0
