"""Port hygiene: the port stands alone and never runs on the CPU in
silence.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``repro`` (the card's machine has no JAX).
* ``chip_smoke.py`` without a card exits non-zero and prints no result.
* Entry points default to ``device="cuda"`` and raise without a card.
* Features of later slices raise ``NotImplementedError``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import demo
from repro_torch.core import fabric as fb
from repro_torch.core import pulse_comm as pc
from repro_torch.kernels import common as kc
from repro_torch.snn import network as net

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    comm = pc.PulseCommConfig(n_chips=2, neurons_per_chip=8,
                              n_inputs_per_chip=8)
    cfg = net.NetworkConfig(comm=comm)
    gen = torch.Generator().manual_seed(0)
    params = net.init_params(gen, cfg, device="cpu")
    state = net.init_state(cfg, params, device="cpu")
    calls = [
        lambda: net.init_params(gen, cfg),
        lambda: net.init_state(cfg, params),
        lambda: net.run(cfg, params, state, np.zeros((1, 2, 8), np.float32)),
        lambda: fb.PulseFabric(comm),
        lambda: demo.main(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("kw", [
    dict(comm_mode="dense"), dict(pipeline=True), dict(flow=object()),
    dict(topology=object()), dict(healthy=[0]), dict(dead_links=((0, 1),)),
    dict(telemetry=True)])
def test_unported_network_features_raise(kw):
    with pytest.raises(NotImplementedError):
        net.NetworkConfig(comm=pc.PulseCommConfig(n_chips=2), **kw)


@pytest.mark.parametrize("name", ["run_plastic", "shard_step",
                                  "shard_superstep", "shard_pipeline_block",
                                  "shard_flush_pending"])
def test_unported_entry_points_raise(name):
    with pytest.raises(NotImplementedError):
        getattr(net, name)()


def test_kernel_build_is_keyed_by_the_sources():
    d = kc.build_dir()
    assert d.parent == ROOT / "build" / "repro_torch"
    assert d == kc.build_dir()
    assert {p.name for p in kc.CSRC.glob("*.cu")} == {
        f"{name}.cu" for name in kc.KERNELS}
