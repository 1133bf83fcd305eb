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

from repro_torch import demo, obs, quickstart, stdp_demo
from repro_torch.launch import monitor, serve
from repro_torch.core import fabric as fb
from repro_torch.core import pulse_comm as pc
from repro_torch.core import resilience as rsl
from repro_torch.core import topology as tpo
from repro_torch.kernels import common as kc
from repro_torch.runtime import ResilientRunner
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


TELEMETRY_AND_RECOVERY = (
    sorted((ROOT / "src" / "repro_torch" / "obs").glob("*.py"))
    + sorted((ROOT / "src" / "repro_torch" / "runtime").glob("*.py"))
    + sorted((ROOT / "src" / "repro_torch" / "checkpoint").glob("*.py"))
    + [ROOT / "src" / "repro_torch" / "core" / "resilience.py",
       ROOT / "src" / "repro_torch" / "launch" / "monitor.py"])


def test_import_check_covers_telemetry_and_recovery():
    """``obs/``, ``runtime/``, ``checkpoint/``, ``core/resilience.py`` and
    ``launch/monitor.py`` are among the files checked above; ``obs``
    imports nothing from ``repro_torch.core`` (the fabric imports its
    phase scopes)."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in TELEMETRY_AND_RECOVERY}
    assert {"obs/metrics.py", "obs/trace.py", "obs/recorder.py",
            "obs/export.py", "obs/conservation.py", "obs/__init__.py",
            "runtime/fault.py", "checkpoint/store.py"} <= names
    for path in TELEMETRY_AND_RECOVERY:
        assert path in PORT_FILES
        if path.parent.name == "obs":
            assert not any(m.startswith("repro_torch.core")
                           for m in _imported_modules(path)), path.name


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


def test_entry_points_default_to_the_card(tmp_path):
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
        lambda: obs.metrics_init(obs.MetricsConfig(), 2),
        lambda: obs.flight_init(4, 2),
        lambda: rsl.health_init(rsl.HealthConfig(n_chips=2)),
        lambda: rsl.credit_watch_init(rsl.HealthConfig(n_chips=2)),
        lambda: monitor.main(["--demo"]),
        lambda: ResilientRunner(
            make_step=lambda h: lambda s, t: net.step(
                cfg, params, s, np.zeros((2, 8), np.float32)),
            detect=lambda s, t, h: None, ckpt_dir=str(tmp_path),
            n_chips=2).run(state, 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("telemetry", [True, obs.MetricsConfig()],
                         ids=["true", "metrics-config"])
def test_telemetry_configs_build(telemetry):
    """Telemetry is ported (held against JAX in tests/test_torch_obs.py):
    ``True`` and a MetricsConfig build a network whose state carries the
    metrics; anything else is refused."""
    cfg = net.NetworkConfig(comm=pc.PulseCommConfig(n_chips=2),
                            telemetry=telemetry)
    params = net.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    state = net.init_state(cfg, params, device="cpu")
    assert isinstance(state.metrics, obs.MetricsCarry)
    assert state.metrics.flight.blocks.shape[0] == (
        obs.MetricsConfig().flight_depth)
    with pytest.raises(TypeError, match="MetricsConfig"):
        net.NetworkConfig(comm=pc.PulseCommConfig(n_chips=2),
                          telemetry=object())


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


@pytest.mark.parametrize("flag", ["--metrics-out", "--events-jsonl"])
def test_serve_writes_metrics_and_events(flag, tmp_path, capsys):
    """``--metrics-out`` writes the Prometheus exposition of the serve
    latencies, ``--events-jsonl`` the prefill and decode events (the
    reference's names, labels and kinds), on the CPU with ``--reduced``."""
    from repro_torch.obs import read_jsonl

    path = tmp_path / "out"
    serve.main(["--device", "cpu", "--arch", "zamba2-2.7b", "--reduced",
                "--batch", "2", "--prompt-len", "5", "--gen", "3", flag,
                str(path)])
    if flag == "--metrics-out":
        text = path.read_text()
        for name in ("prefill_ms", "prefill_tok_s", "decode_ms",
                     "decode_tok_s", "decode_ms_per_step",
                     "tokens_generated"):
            assert f"# TYPE repro_serve_{name} gauge" in text
        assert ('repro_serve_tokens_generated{arch="zamba2-2.7b",'
                'batch="2"} 6') in text
        assert "# metrics exposition" in capsys.readouterr().out
    else:
        rows = list(read_jsonl(str(path)))
        assert [r["kind"] for r in rows] == ["prefill", "decode"]
        assert rows[0]["prompt_len"] == 5 and rows[1]["steps"] == 3


@pytest.mark.parametrize("argv,match", [
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
