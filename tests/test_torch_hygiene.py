"""Port hygiene: the port stands alone and never runs on the CPU in
silence.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``repro`` (the card's machine has no JAX).
* ``chip_smoke.py`` without a card exits non-zero and prints no result.
* Entry points default to ``device="cuda"`` and raise without a card.
* Features of later slices raise ``NotImplementedError``.
* Each ctypes signature matches its C launcher.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import demo, quickstart, stdp_demo
from repro_torch.launch import serve
from repro_torch.core import fabric as fb
from repro_torch.core import pulse_comm as pc
from repro_torch.core import topology as tpo
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


def test_import_check_covers_the_topology_module():
    """``core/topology.py`` (numpy route compiler and the routed exchange)
    is among the files checked above, and imports neither JAX nor the
    JAX package."""
    path = ROOT / "src" / "repro_torch" / "core" / "topology.py"
    assert path in PORT_FILES
    assert _imported_modules(path) == {"__future__", "dataclasses",
                                       "functools", "typing", "numpy",
                                       "torch", "repro_torch.core"}


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_reads_flash_spills_of_both_types():
    """``chip_smoke.flash_spills`` reads ptxas's report per instance: the
    bf16 (wgmma) and float32 (3xTF32) kernels by DN, so a spill at DN 80
    or 128 in either fails the build phase."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_128"
        "flash_attention_wgmma_kernelILi80EEEv14CUtensorMap_st' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_129"
        "flash_attention_tf32x3_kernelILi128EEEvPKfS2_S2_Pfiiiiiiif' for "
        "'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_1"
        "12other_kernelEv' for 'sm_90a'",
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads"])
    assert smoke.flash_spills(log) == {"bf16": {80: 0}, "f32": {128: 24}}


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
        lambda: net.run_plastic(cfg, params, state,
                                np.zeros((1, 2, 8), np.float32)),
        lambda: fb.PulseFabric(comm),
        lambda: demo.main(),
        lambda: stdp_demo.main(),
        lambda: quickstart.main(),
        lambda: serve.main(["--arch", "zamba2-2.7b", "--reduced"]),
        lambda: serve.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("kw", [dict(telemetry=True),
                                dict(telemetry=object())])
def test_unported_network_features_raise(kw):
    """Telemetry is ROADMAP section 1, item 6."""
    with pytest.raises(NotImplementedError, match="item 6"):
        net.NetworkConfig(comm=pc.PulseCommConfig(n_chips=2), **kw)


@pytest.mark.parametrize("kw", [
    dict(topology=tpo.ring(2)), dict(healthy=[0]),
    dict(topology=tpo.ring(2), dead_links=((0, 1),))])
def test_topology_and_health_configs_build(kw):
    """Topologies and health masks are ported (held against JAX in
    tests/test_torch_topology.py and tests/test_torch_degraded.py); a
    topology of another chip count, or no Topology at all, is refused."""
    net.NetworkConfig(comm=pc.PulseCommConfig(n_chips=2), **kw)
    with pytest.raises(ValueError, match="chips"):
        net.NetworkConfig(comm=pc.PulseCommConfig(n_chips=4), **kw,
                          **({} if "topology" in kw
                             else dict(topology=tpo.ring(2))))
    with pytest.raises(TypeError, match="Topology"):
        net.NetworkConfig(comm=pc.PulseCommConfig(n_chips=2),
                          **dict(kw, topology=object()))


@pytest.mark.parametrize("kw", [dict(pipeline=True),
                                dict(flow=fb.FlowControlConfig()),
                                dict(pipeline=True,
                                     flow=fb.FlowControlConfig())])
def test_pipeline_and_flow_configs_build(kw):
    net.NetworkConfig(comm=pc.PulseCommConfig(n_chips=2), **kw)
    with pytest.raises(ValueError, match="dense"):
        net.NetworkConfig(comm=pc.PulseCommConfig(n_chips=2),
                          comm_mode="dense", **dict(kw, pipeline=True))


@pytest.mark.parametrize("name", ["shard_step",
                                  "shard_superstep", "shard_pipeline_block",
                                  "shard_flush_pending"])
def test_unported_entry_points_raise(name):
    with pytest.raises(NotImplementedError, match="item 7"):
        getattr(net, name)()


def test_kernel_build_is_keyed_by_the_sources():
    d = kc.build_dir()
    assert d.parent == ROOT / "build" / "repro_torch"
    assert d == kc.build_dir()
    assert {p.name for p in kc.CSRC.glob("*.cu")} == {
        f"{name}.cu" for name in kc.SOURCES}
    assert set(kc.KERNELS.values()) == set(kc.SOURCES)


def test_kernel_fn_sets_each_signature_once(monkeypatch):
    """The ctypes function of a (source, symbol) is looked up and given its
    signature on the first call only; later calls return it as it is."""
    looked_up = []

    class Lib:
        def __getattr__(self, symbol):
            looked_up.append(symbol)
            return type("Fn", (), {})()

    monkeypatch.setitem(kc._libs, "lif_step", Lib())
    monkeypatch.setattr(kc, "_fns", {})
    argtypes = [kc.P, kc.LL]
    first = kc.kernel_fn("lif_step", "lif_step_launch", argtypes)
    assert kc.kernel_fn("lif_step", "lif_step_launch", argtypes) is first
    assert looked_up == ["lif_step_launch"]
    assert first.argtypes == argtypes and first.restype is kc.I


def _c_params(source: str, symbol: str) -> list[str]:
    """The parameter types of ``extern "C" int symbol(...)`` in a CUDA
    source, as ctypes names: a pointer, ``long long``, ``float`` or
    ``int``."""
    import re

    text = (kc.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text,
                  re.S)
    assert m, f"{symbol} not in {source}"
    kinds = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        kinds.append("P" if "*" in decl else
                     "LL" if "long long" in decl else
                     "F" if decl.startswith("float ") else "I")
    return kinds


@pytest.mark.parametrize("module,attr,source,symbol", [
    ("fused_inject", "_ARGTYPES", "fused_inject.cu", "fused_inject_launch"),
    ("fused_inject", "_LIF_ARGTYPES", "fused_inject.cu",
     "fused_lif_inject_launch"),
    ("fused_drain", "_ARGTYPES", "fused_drain.cu", "fused_drain_launch"),
    ("bucket_pack", "_ARGTYPES", "bucket_pack.cu", "bucket_pack_launch"),
    ("lif_step", "_ARGTYPES", "lif_step.cu", "lif_step_launch"),
    ("merge_sort", "_WORDS_ARGTYPES", "merge_sort.cu",
     "merge_sort_words_launch"),
    ("merge_sort", "_SOA_ARGTYPES", "merge_sort.cu", "merge_sort_launch"),
    ("flash_attention", "_ARGTYPES", "flash_attention.cu",
     "flash_attention_launch"),
    ("ssm_scan", "_ARGTYPES", "ssm_scan.cu", "ssm_scan_launch")])
def test_ctypes_signatures_match_the_c_entry_points(module, attr, source,
                                                    symbol):
    """ctypes passes an argument beyond ``argtypes`` as a 32-bit int, which
    cuts a pointer: every C launcher's parameter list must match its
    wrapper's ``argtypes`` one for one (the stream included)."""
    import importlib

    ops = importlib.import_module(f"repro_torch.kernels.{module}.ops")
    names = {kc.P: "P", kc.I: "I", kc.LL: "LL", kc.F: "F"}
    assert [names[t] for t in getattr(ops, attr)] == _c_params(source, symbol)


def _lm_unported(feature: str):
    """Call the port's LM API with one feature a later slice brings."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import attention as attn
    from repro_torch.models import lm
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm

    zamba = C.get("zamba2-2.7b").reduced()
    dense = C.get("internlm2-1.8b").reduced()
    x = torch.zeros((1, 2, 4, 16))
    if feature == "window":
        attn.prefill_attention(x, x, x, window=4)
    elif feature == "window decode":
        attn.decode_attention(x[:, :, :1], attn.KVCache(k=x, v=x), 4,
                              window=4)
    elif feature == "ssm_version 1":
        ssm.ssm_spec(dataclasses.replace(zamba, ssm_version=1))
    elif feature == "ssd":
        ssm.ssm_spec(dataclasses.replace(zamba, ssm_impl="ssd"))
    elif feature == "moe":
        tfm.decoder_spec(dataclasses.replace(dense, family="moe",
                                             n_experts=4, top_k=2))
    elif feature == "encoder-decoder":
        lm.init(torch.Generator(), dataclasses.replace(dense,
                                                       encoder_layers=2),
                device="cpu")
    else:
        lm.loss_fn()


@pytest.mark.parametrize("feature,match", [
    ("window", "window"), ("window decode", "window"),
    ("ssm_version 1", "Mamba-1"), ("ssd", "ssd"), ("moe", "MoE"),
    ("encoder-decoder", "encoder-decoder"), ("training", "training")])
def test_unported_lm_features_raise(feature, match):
    with pytest.raises(NotImplementedError, match=match):
        _lm_unported(feature)


@pytest.mark.parametrize("argv,match", [
    (["--device", "cpu", "--reduced", "--metrics-out", "m.prom"], "obs"),
    (["--device", "cpu", "--reduced", "--events-jsonl", "e.jsonl"], "obs"),
    (["--device", "cpu", "--arch", "falcon-mamba-7b", "--reduced"],
     "Mamba-1"),
    (["--device", "cpu", "--arch", "granite-moe-1b-a400m", "--reduced"],
     "MoE"),
    (["--device", "cpu", "--arch", "whisper-medium", "--reduced"],
     "encoder-decoder")])
def test_unported_serve_features_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        serve.main(argv)


def test_serve_runs_on_the_cpu_when_asked(capsys):
    ids = serve.main(["--device", "cpu", "--arch", "zamba2-2.7b", "--reduced",
                      "--batch", "2", "--prompt-len", "9", "--gen", "3"])
    assert ids.shape == (2, 3) and ids.dtype == torch.int32
    out = capsys.readouterr().out
    assert "prefill: 2x9 in" in out and "decode: 3 steps x batch 2" in out
