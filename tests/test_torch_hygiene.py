"""Port hygiene: the port stands alone and never runs on the CPU in
silence.

* No module of ``src/repro_torch``, not ``chip_smoke.py`` and no card
  tool under ``tools/`` imports ``jax`` or the JAX package ``repro``
  (the card's machine has no JAX).
* ``chip_smoke.py`` without a card exits non-zero and prints no result.
* Entry points default to ``device="cuda"`` and raise without a card.
* Features of later slices raise ``NotImplementedError``; the shard
  forms raise without a process group.
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

from repro_torch import demo, obs, quickstart, stdp_demo, train_lm
from repro_torch.data import pipeline as dp
from repro_torch.launch import monitor, serve, train
from repro_torch.core import fabric as fb
from repro_torch.core import pulse_comm as pc
from repro_torch.core import resilience as rsl
from repro_torch.core import topology as tpo
from repro_torch.kernels import common as kc
from repro_torch.runtime import ResilientRunner
from repro_torch.snn import network as net

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


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


SHARD_MODULES = [ROOT / "src" / "repro_torch" / "launch" / "mesh.py",
                 ROOT / "src" / "repro_torch" / "core" / "transport.py"]


def test_import_check_covers_the_shard_modules():
    """``launch/mesh.py`` and ``core/transport.py`` (the multi-GPU
    transport) are among the files checked above and import only torch
    and the standard library; ``network.py`` exports the shard forms."""
    for path in SHARD_MODULES:
        assert path in PORT_FILES
        assert {m.split(".")[0] for m in _imported_modules(path)} <= {
            "__future__", "dataclasses", "math", "typing", "torch"}, path
    assert {"shard_fabric", "shard_step", "shard_superstep",
            "shard_pipeline_block", "shard_flush_pending",
            "shard_slice"} <= set(net.__all__)


LM_SHARD_MODULES = [
    ROOT / "src" / "repro_torch" / "models" / "sharding.py",
    ROOT / "src" / "repro_torch" / "optim" / "compression.py"]


def test_import_check_covers_the_lm_sharding_modules():
    """``models/sharding.py`` and ``optim/compression.py`` are among the
    files checked above and import only torch, the standard library and
    the port; ``make_compressed_step`` is ported."""
    for path in LM_SHARD_MODULES:
        assert path in PORT_FILES
        assert {m.split(".")[0] for m in _imported_modules(path)} <= {
            "__future__", "dataclasses", "typing", "torch",
            "repro_torch"}, path
    assert "raise NotImplementedError" not in (
        ROOT / "src" / "repro_torch" / "launch" / "train.py").read_text()


class _FakeEvent:
    def __init__(self, name, device=True):
        self.name = name
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"


def _fake_profiler(sessions: list):
    """A stand-in for ``torch.profiler.profile`` whose n-th session
    records the events ``sessions[n]``."""

    class Profile:
        def __init__(self, *args, **kwargs):
            self._events = sessions.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self._events

    return Profile


def test_profiled_retries_a_session_that_misses_the_expected_kernel(
        monkeypatch):
    """``kc.profiled``: a session with no device activity, then one that
    caught PyTorch's kernels but not the expected one, are retried; the
    third, which holds it, is returned.  Without ``expect`` the second
    would do.  No session with the kernel: it raises, naming the
    pattern."""
    torch_kernel = _FakeEvent("void at::native::reduce_kernel<512, 1>")
    ours = _FakeEvent("ssm_scan_bwd_kernel<4, 8>")
    cpu = _FakeEvent("aten::sum", device=False)
    runs = []

    def window():
        runs.append(1)
        return len(runs)

    monkeypatch.setattr(torch.profiler, "profile", _fake_profiler(
        [[cpu], [cpu, torch_kernel], [cpu, torch_kernel, ours]]))
    prof, out = kc.profiled(window, "probe", expect="ssm_scan_bwd_kernel")
    assert out == 3 and ours in prof.events()
    monkeypatch.setattr(torch.profiler, "profile", _fake_profiler(
        [[cpu], [cpu, torch_kernel], [cpu, torch_kernel, ours]]))
    assert kc.profiled(window, "probe")[1] == 5
    monkeypatch.setattr(torch.profiler, "profile",
                        _fake_profiler([[torch_kernel]] * 3))
    with pytest.raises(AssertionError,
                       match="probe: .*no device activity matching "
                             "'ssm_scan_bwd_kernel' in 3 sessions"):
        kc.profiled(window, "probe", tries=3, expect="ssm_scan_bwd_kernel")
    assert len(runs) == 8


def test_mesh_module_touches_no_device_state_at_import():
    """``launch/mesh.py`` holds functions only: importing it builds no
    mesh and touches no device or process group (the reference's rule
    for its dry-run)."""
    tree = ast.parse((SHARD_MODULES[0]).read_text())
    for node in tree.body:
        assert isinstance(node, (ast.Import, ast.ImportFrom,
                                 ast.FunctionDef)) or (
            isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Constant)), ast.dump(node)[:80]
    from repro_torch.launch import mesh as ms
    assert not torch.distributed.is_initialized()
    for build in (ms.make_chip_mesh, ms.make_host_mesh,
                  ms.make_production_mesh):
        with pytest.raises(RuntimeError, match="init_process_group"):
            build()


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_loads_mamba1_published_a(dtype):
    """``chip_smoke.set_general_a`` sets every Mamba-1 layer's A_log of a
    parameter tree, in place and in its own type, to log(n + 1), so A =
    -exp(A_log) is about -(n + 1) and no row of it is constant (the
    reference's init, zeros, makes every row constant); ``mamba1_a`` is
    the same A as a [di, N] tensor."""
    import dataclasses
    import importlib.util

    from repro_torch import configs as C
    from repro_torch.models import lm

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(C.get("falcon-mamba-7b").reduced(),
                              dtype=dtype)
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    a_log = params["blocks"]["pos0"]["ssm"]["A_log"]
    assert not a_log.any()
    smoke.set_general_a(params)
    assert params["blocks"]["pos0"]["ssm"]["A_log"] is a_log
    assert a_log.dtype == getattr(torch, dtype)
    assert a_log.shape == (cfg.n_layers, cfg.d_inner, cfg.ssm_state)
    a = -torch.exp(a_log.float())
    want = smoke.mamba1_a(cfg.d_inner, cfg.ssm_state, "cpu")
    assert bool((a[0] != a[0][:, :1]).any(-1).all())
    torch.testing.assert_close(a, want.expand_as(a), rtol=2**-7, atol=0)


def test_chip_smoke_reads_flash_spills_of_both_types():
    """``chip_smoke.ptxas_by_dn`` reads ptxas's report per instance: the
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
    assert smoke.ptxas_by_dn(log, smoke.FLASH_INSTANCES.values()) == {
        "flash_attention_wgmma_kernel": {"80": (None, 0)},
        "flash_attention_tf32x3_kernel": {"128": (None, 24)}}


def test_chip_smoke_reads_the_scan_backward_instances():
    """``chip_smoke.ptxas_instances`` reads (registers, spill bytes) of
    every instance of the scan's backward by its template arguments, and
    leaves the forward's ``ssm_scan_kernel`` (whose mangled name differs
    in its length prefix) out; ``ptxas_frames`` and ``sass_instances``
    read the per-head backward's instances (registers, spills, stack
    frame; TF32 HMMA and atomics), the non-template kernel among them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119"
        "ssm_scan_bwd_kernelIfLi8ELi2EEEvPKT_PKfS5_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_119",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119"
        "ssm_scan_bwd_kernelI13__nv_bfloat16Li32ELi1EEEvPKT_PKfS5_' for "
        "'sm_90a'",
        "ptxas info    : Used 255 registers, used 1 barriers",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115"
        "ssm_scan_kernelIfLi8ELi2ELb1EEEvPKT_PKfS5_' for 'sm_90a'",
        "ptxas info    : Used 96 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"])
    assert smoke.ptxas_instances(log, "ssm_scan_bwd_kernel") == {
        "fLi8ELi2": (168, 0), "13__nv_bfloat16Li32ELi1": (255, 12)}
    assert smoke.ptxas_instances(log, "ssm_scan_kernel") == {
        "fLi8ELi2ELb1": (96, 0)}
    # The per-head backward (ssm_scan_bwd_chunked.cu): its template
    # instances and the non-template end-state kernel, with the stack
    # frame; its SASS by instance (TF32 HMMA, atomics).
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125"
        "ssm_scan_heads_bwd_kernelIfLb0EEEvPKT_PKfS5_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125"
        "ssm_scan_heads_bwd_kernelI13__nv_bfloat16Lb1EEEvPKT_PKfS5_' for "
        "'sm_90a'",
        "    16 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_128"
        "ssm_scan_heads_dstate_kernelEPKfS1_S1_S1_S1_iiPf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119"
        "ssm_scan_bwd_kernelIfLi8ELi2EEEvPKT_PKfS5_' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers"])
    assert smoke.ptxas_frames(log, smoke.SCAN_HEADS_KERNELS) == {
        "ssm_scan_heads_bwd_kernel<fLb0>": (168, 0, 0),
        "ssm_scan_heads_bwd_kernel<13__nv_bfloat16Lb1>": (255, 8, 16),
        "ssm_scan_heads_dstate_kernel": (90, 0, 0)}
    sass = "\n".join([
        "        Function : _ZN12_GLOBAL__N_125ssm_scan_heads_bwd_kernelIfLb1"
        "EEEvPKT_PKfS5_",
        "        /*0100*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        "        /*0110*/  HMMA.1688.F32.TF32 R4, R8, R14, R4 ;",
        "        Function : _ZN12_GLOBAL__N_128ssm_scan_heads_dstate_kernel"
        "EPKfS1_S1_S1_S1_iiPf",
        "        /*0100*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        "        /*0200*/  RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;",
        "        Function : _ZN12_GLOBAL__N_119ssm_scan_bwd_kernelIfLi8ELi2EE"
        "EvPKT_PKfS5_",
        "        /*0100*/  FFMA R4, R8, R12, R4 ;"])
    assert smoke.sass_instances(sass, smoke.SCAN_HEADS_KERNELS,
                                r"HMMA\S*\.TF32") == {
        "ssm_scan_heads_bwd_kernel<fLb1>": (2, 0),
        "ssm_scan_heads_dstate_kernel": (1, 1)}


@pytest.mark.parametrize("t,x_bf16,dh", [(64, True, False),
                                          (200, True, True),
                                          (512, False, False)])
def test_chip_smoke_counts_what_the_scan_heads_backward_needs(t, x_bf16, dh):
    """``chip_smoke.heads_bwd_ops`` (the per-head backward's bound) counts
    each product at what the gradient needs, held against a count of the
    index pairs each product keeps, times the size of its third index,
    from numpy masks chunk by chunk: the causal mask's lower triangle for the
    four masked products and C B^T (once for all heads), no product with
    the first chunk's zero h0 or its unneeded start-state gradient, none
    with the last chunk's zero G when no final-state gradient is given;
    three TF32 products a product, two where it reads a bf16 x."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    b, nh, p, n = 2, 3, 64, 16
    xw = 2 if x_bf16 else 3
    want = 0
    for c0 in range(0, t, 64):
        q = min(64, t - c0)
        causal = np.tril(np.ones((q, q), bool))   # [t, s], t >= s
        ones = lambda *shape: np.ones(shape, bool)  # noqa: E731
        first, last_zero_g = c0 == 0, c0 + q >= t and not dh
        # (TF32 products, kept pairs of two indices, size of the third):
        # the masked products keep (t, s) pairs, t >= s; the others keep
        # every (row, column) pair and sum over the inner index.
        prods = [(3, causal, p), (xw, causal, p),     # M^T dy, dy x^T
                 (3, causal, n), (3, causal, n)]      # dM~ B, dM~^T C
        if not first:
            prods += [(3, ones(q, n), p),             # dy h0
                      (3, ones(p, n), q)]             # dy^T C
        if not last_zero_g:
            prods += [(3, ones(q, p), n),             # B G^T
                      (xw, ones(q, n), p)]            # x G
        per_head = sum(w * int(m.sum()) * k for w, m, k in prods)
        want += nh * per_head + 3 * int(causal.sum()) * n   # C B^T
    assert smoke.heads_bwd_ops(b, t, nh, p, n, x_bf16, dh) == 2 * b * want // 3


def test_chip_smoke_reads_the_backward_kernels_registers_and_spills():
    """``chip_smoke.ptxas_by_dn`` reads (registers, spill bytes) of each
    backward instance by kernel and DN, whichever order
    ptxas prints the two lines in, and ``bwd_design`` lists every
    instance of a route at the DN a head size rounds up to."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_133"
        "flash_attention_bwd_dq_mma_kernelILi128EEEvPK13__nv_bfloat16' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 164 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_135"
        "flash_attention_bwd_dkdv_mma_kernelILi128EEEvPK13__nv_bfloat16'"
        " for 'sm_90a'",
        "ptxas info    : Used 245 registers, used 1 barriers",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_135"
        "flash_attention_bwd_dkdv_mma_kernelILi80EEEvPK13__nv_bfloat16'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 165 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_136"
        "flash_attention_bwd_dq_tf32x3_kernelILi80EEEvPKf' for 'sm_90a'",
        "ptxas info    : Used 148 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"])
    names = sum(smoke.FLASH_BWD_ROUTES.values(), ())
    got = smoke.ptxas_by_dn(log, names)
    assert got == {"flash_attention_bwd_dq_mma_kernel": {"128": (164, 0)},
                   "flash_attention_bwd_dkdv_mma_kernel": {
                       "128": (245, 12), "80": (165, 0)},
                   "flash_attention_bwd_dq_tf32x3_kernel": {"80": (148, 0)},
                   "flash_attention_bwd_dkdv_tf32x3_kernel": {}}
    assert smoke.bwd_design("mma_bf16", 120, got) == (
        "mma_bf16 (dq<128> 164 registers 0 spill bytes, dkdv<128> 245 "
        "registers 12 spill bytes)")
    assert all(any(k.startswith(p) for p in smoke.FLASH_BWD_KERNELS)
               for k in names)
    sass = "\n".join([
        "\t\tFunction : _ZN3_GLOBAL__N_135flash_attention_bwd_dkdv_mma_"
        "kernelILi80EEEvPK13__nv_bfloat16",
        "        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, RZ ;",
        "        /*0110*/  HMMA.16816.F32.BF16 R4, R8, R14, R4 ;",
        "\t\tFunction : _ZN3_GLOBAL__N_136flash_attention_bwd_dq_tf32x3_"
        "kernelILi64EEEvPKf",
        "        /*0200*/  FFMA R1, R2, R3, R1 ;",
        "        /*0210*/  RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;",
        "\t\tFunction : _ZN3_GLOBAL__N_112other_kernelEv",
        "        /*0300*/  HMMA.16816.F32.BF16 R4, R8, R12, RZ ;"])
    assert smoke.sass_instances(sass, names) == {
        "flash_attention_bwd_dkdv_mma_kernel<Li80>": (2, 0),
        "flash_attention_bwd_dq_tf32x3_kernel<Li64>": (0, 1)}
    # The float32 route's check counts TF32 products alone.
    tf32 = "\n".join([
        "\t\tFunction : _ZN3_GLOBAL__N_138flash_attention_bwd_dkdv_"
        "tf32x3_kernelILi128EEEvPKf",
        "        /*0100*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        "        /*0110*/  HMMA.16816.F32.BF16 R4, R8, R14, R4 ;"])
    assert smoke.sass_instances(tf32, names, r"HMMA\S*\.TF32") == {
        "flash_attention_bwd_dkdv_tf32x3_kernel<Li128>": (1, 0)}


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
        lambda: train.main(["--reduced", "--ckpt-dir", str(tmp_path)]),
        lambda: train_lm.main(["--ckpt-dir", str(tmp_path)]),
        lambda: dp.Prefetcher(iter([(0, {"x": np.zeros(2)})])).__next__(),
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
def test_shard_forms_need_a_process_group(name):
    """The shard forms (held against JAX in tests/test_torch_shard.py, in
    gloo processes) exchange through torch.distributed: with no process
    group they raise, and never fall back to the local exchange."""
    assert not torch.distributed.is_initialized()
    b = 1 if name == "shard_step" else 2
    cfg = net.NetworkConfig(
        comm=pc.PulseCommConfig(n_chips=2, neurons_per_chip=8,
                                n_inputs_per_chip=8, superstep=b),
        pipeline=name in ("shard_pipeline_block", "shard_flush_pending"))
    params = net.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    state = net.init_state(cfg, params, device="cpu")
    ext = torch.zeros((b, 2, 8)) if b > 1 else torch.zeros((2, 8))
    args = ((cfg, "chip", state) if name == "shard_flush_pending"
            else (cfg, "chip", params, state, ext))
    with pytest.raises(RuntimeError, match="init_process_group"):
        getattr(net, name)(*args, mesh=None)
    assert name in net.__all__


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


def test_variant_swaps_a_sources_build_and_restores_it():
    """``kc.variant`` (the A/B tools' hook): within the block every kernel
    of the source gets its entry points from the other build, through
    ``kernel_fn`` as the wrappers call it; after the block the tree's
    functions are back, whether the source was loaded before or not."""
    from types import SimpleNamespace

    def entry():
        return 0

    other = SimpleNamespace(ssm_scan_heads_bwd_group=entry)
    mine = SimpleNamespace(ssm_scan_heads_bwd_group=lambda: 5)
    src = kc.KERNELS["ssm_scan_heads_bwd"]
    saved = kc._libs.get(src), dict(kc._fns)
    try:
        for before in (None, mine):
            kc._libs.pop(src, None)
            kc._fns.clear()
            if before is not None:
                kc._libs[src] = before
                kc.kernel_fn("ssm_scan_heads_bwd",
                             "ssm_scan_heads_bwd_group", [])
            with kc.variant("ssm_scan_heads_bwd", other):
                fn = kc.kernel_fn("ssm_scan_heads_bwd",
                                  "ssm_scan_heads_bwd_group", [])
                assert fn is entry and fn.argtypes == []
            assert kc._libs.get(src) is before
            if before is None:
                assert not kc._fns
            else:
                assert kc._fns[(src, "ssm_scan_heads_bwd_group")]() == 5
    finally:
        kc._libs.pop(src, None)
        if saved[0] is not None:
            kc._libs[src] = saved[0]
        kc._fns.clear()
        kc._fns.update(saved[1])


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
    ("flash_attention", "_BWD_ARGTYPES", "flash_attention_bwd.cu",
     "flash_attention_bwd_launch"),
    ("ssm_scan", "_ARGTYPES", "ssm_scan.cu", "ssm_scan_launch"),
    ("ssm_scan", "_BWD_ARGTYPES", "ssm_scan_bwd.cu", "ssm_scan_bwd_launch"),
    ("ssm_scan", "_CHUNKS_BWD_ARGTYPES", "ssm_scan_bwd.cu",
     "ssm_scan_bwd_chunks_launch"),
    ("ssm_scan", "_HEADS_BWD_ARGTYPES", "ssm_scan_bwd_chunked.cu",
     "ssm_scan_heads_bwd_launch"),
    ("ssd", "_ARGTYPES", "ssd_chunked.cu", "ssd_chunked_launch")])
def test_ctypes_signatures_match_the_c_entry_points(module, attr, source,
                                                    symbol):
    """ctypes passes an argument beyond ``argtypes`` as a 32-bit int, which
    cuts a pointer: every C launcher's parameter list must match its
    wrapper's ``argtypes`` one for one (the stream included)."""
    import importlib

    ops = importlib.import_module(f"repro_torch.kernels.{module}.ops")
    names = {kc.P: "P", kc.I: "I", kc.LL: "LL", kc.F: "F"}
    assert [names[t] for t in getattr(ops, attr)] == _c_params(source, symbol)


def _lm_unported(feature: str) -> torch.Tensor:
    """Call the port's LM API with one feature that raised before the
    long-context slice; returns its output."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import attention as attn
    from repro_torch.models import spec as sp
    from repro_torch.models import ssm

    zamba = C.get("zamba2-2.7b").reduced()
    x = torch.randn((1, 2, 6, 16), generator=torch.Generator().manual_seed(0))
    if feature == "window":
        return attn.prefill_attention(x, x, x, window=4)
    if feature == "window decode":
        return attn.decode_attention(x[:, :, :1], attn.KVCache(k=x, v=x), 6,
                                     window=4)
    cfg = dataclasses.replace(zamba, ssm_impl="ssd")
    p = sp.init_tree(torch.Generator().manual_seed(0), ssm.ssm_spec(cfg),
                     torch.float32, "cpu")
    return ssm.ssm_apply(cfg, p, torch.randn(
        (1, 9, cfg.d_model), generator=torch.Generator().manual_seed(1)))


@pytest.mark.parametrize("feature", ["window", "window decode", "ssd"],
                         ids=["window-window", "window decode-window",
                              "ssd-ssd"])
def test_unported_lm_features_raise(feature):
    """The three features that raised before the long-context slice (a
    windowed prefill, windowed decode, ``ssm_impl="ssd"``) now run on the
    CPU and give finite outputs of their shapes.  The test keeps the name
    and case ids it had while it held them to raising, so that its
    history stays one test."""
    out = _lm_unported(feature)
    want = {"window": (1, 2, 6, 16), "window decode": (1, 2, 1, 16),
            "ssd": (1, 9, 64)}[feature]
    assert tuple(out.shape) == want and bool(torch.isfinite(out).all())


def test_moe_decoder_spec_builds():
    """The MoE block is ported: the call that raised before this slice (a
    dense config turned MoE) and the reduced granite-moe build their
    ``attn_moe`` blocks, the experts' leaves stacked over the repeats."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import transformer as tfm

    dense = C.get("internlm2-1.8b").reduced()
    for cfg in (dataclasses.replace(dense, family="moe", n_experts=4,
                                    top_k=2),
                C.get("granite-moe-1b-a400m").reduced()):
        spec = tfm.decoder_spec(cfg)
        moe = spec["blocks"]["pos0"]["moe"]
        assert "mlp" not in spec["blocks"]["pos0"]
        assert moe["w_gate"].shape == (cfg.n_layers, 4, cfg.d_model,
                                       cfg.d_ff)
        assert moe["router"].shape == (cfg.n_layers, cfg.d_model, 4)


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


def test_serve_runs_granite_moe_on_the_cpu(capsys):
    """``launch.serve`` on reduced granite-moe-1b-a400m with ``--device
    cpu`` (the call that raised before the MoE slice): ids in range, its
    three lines printed, no kernel launched."""
    kc.reset_launches()
    ids = serve.main(["--device", "cpu", "--arch", "granite-moe-1b-a400m",
                      "--reduced"])
    assert ids.shape == (4, 16) and ids.dtype == torch.int32
    assert bool(((ids >= 0) & (ids < 256)).all())
    out = capsys.readouterr().out
    assert "prefill: 4x32 in" in out and "decode: 16 steps x batch 4" in out
    assert "sample output ids:" in out
    assert not any(kc.launches.values())


def test_mamba1_ignores_ssm_impl():
    """As in the reference, ``ssm_impl`` applies to Mamba-2 only: a
    Mamba-1 config with "ssd" builds the same block and gives the same
    output as with "scan", while Mamba-2 with "ssd" takes the
    chunk-parallel route and gives the scan's output within 1e-5 of its
    largest (the same recurrence summed in another order)."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import spec as sp
    from repro_torch.models import ssm

    cfg = C.get("falcon-mamba-7b").reduced()
    ssd = dataclasses.replace(cfg, ssm_impl="ssd")
    spec = ssm.ssm_spec(ssd)
    assert spec == ssm.ssm_spec(cfg)
    p = sp.init_tree(torch.Generator().manual_seed(0), spec, torch.float32,
                     "cpu")
    x = torch.randn(2, 9, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(ssm.ssm_apply(ssd, p, x), ssm.ssm_apply(cfg, p, x))
    zamba = C.get("zamba2-2.7b").reduced()
    pz = sp.init_tree(torch.Generator().manual_seed(2), ssm.ssm_spec(zamba),
                      torch.float32, "cpu")
    xz = torch.randn(2, 9, zamba.d_model,
                     generator=torch.Generator().manual_seed(3))
    scan = ssm.ssm_apply(zamba, pz, xz)
    chunked = ssm.ssm_apply(dataclasses.replace(zamba, ssm_impl="ssd",
                                                ssd_chunk=4), pz, xz)
    assert float((chunked - scan).abs().max()) <= 1e-5 * float(
        scan.abs().max())


def test_serve_runs_falcon_mamba_on_the_cpu(capsys):
    """``launch.serve`` on reduced falcon-mamba-7b (Mamba-1) with
    ``--device cpu``: ids in range, its three lines printed, no kernel
    launched."""
    kc.reset_launches()
    ids = serve.main(["--device", "cpu", "--arch", "falcon-mamba-7b",
                      "--reduced", "--batch", "2", "--prompt-len", "9",
                      "--gen", "3"])
    assert ids.shape == (2, 3) and ids.dtype == torch.int32
    assert bool(((ids >= 0) & (ids < 256)).all())
    out = capsys.readouterr().out
    assert "prefill: 2x9 in" in out and "decode: 3 steps x batch 2" in out
    assert "sample output ids:" in out
    assert not any(kc.launches.values())


def test_train_cli_runs_falcon_mamba_on_the_cpu(tmp_path, capsys):
    """``launch.train`` on reduced falcon-mamba-7b with ``--device cpu``:
    finite losses every step, a committed checkpoint, and a rerun
    resumes from it."""
    argv = ["--device", "cpu", "--arch", "falcon-mamba-7b", "--reduced",
            "--steps", "3", "--batch", "2", "--seq", "16", "--log-every",
            "1", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    state = train.main(argv)
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses)), out
    assert "done" in out
    assert int(state["opt"].count) == 3
    train.main(argv)
    assert "resumed from step" in capsys.readouterr().out


def test_serve_runs_on_the_cpu_when_asked(capsys):
    ids = serve.main(["--device", "cpu", "--arch", "zamba2-2.7b", "--reduced",
                      "--batch", "2", "--prompt-len", "9", "--gen", "3"])
    assert ids.shape == (2, 3) and ids.dtype == torch.int32
    out = capsys.readouterr().out
    assert "prefill: 2x9 in" in out and "decode: 3 steps x batch 2" in out
