"""Device check, CUDA build-and-load, and launch counters for the kernels.

Each kernel is one CUDA C++ source under ``repro_torch/csrc/`` with a
plain C entry point.  At first use the sources are compiled by ``nvcc``
for ``sm_90a`` (one process per source, all started together) into
``build/repro_torch/<hash of the sources>/`` at the root of the checkout
(an installed package builds under ``$XDG_CACHE_HOME/repro_torch``, by
default ``~/.cache/repro_torch``), and loaded with ``ctypes``; nothing includes PyTorch's headers.  A wrapper
launches its kernel only for CUDA tensors and raises when the launch
fails; for CPU tensors it runs the plain PyTorch version.

``launches`` counts kernel launches per kernel (one per wrapper call that
reached the card), so a run can show that it went through the kernels;
:func:`card_kernels` lists what one call put on the card, through
:func:`profiled`, which every reading of torch.profiler goes through;
:func:`graph_ms` times a call over a CUDA graph; :func:`variant` lets the
wrappers of a kernel launch another build of its source (for A/B runs).
``KERNELS`` maps each kernel to the source (and library) it is built
from; ``fused_inject.cu`` and ``merge_sort.cu`` each hold two kernels,
``flash_attention_bwd`` is one count for the two kernels (dQ, then dK
and dV) that one call of its launcher starts, ``ssm_scan_bwd`` counts
one per call of either form (the chunk form's carry and chunk kernels,
or the walk form's kernel; the ``torch.sum`` of the partial sums is not
a launch of it), and ``ssm_scan_heads_bwd`` (``ssm_scan_bwd_chunked.cu``,
the scan's backward for a per-head decay) counts one per call, whether
the call starts one kernel or two, and so does ``ssd_chunked`` (Mamba-2's
chunk-parallel scan: three kernels a call).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("bucket_pack", "fused_inject", "fused_drain", "lif_step",
           "merge_sort", "flash_attention", "flash_attention_bwd", "ssm_scan",
           "ssm_scan_bwd", "ssm_scan_bwd_chunked", "ssd_chunked")
KERNELS = {"fused_inject": "fused_inject", "fused_lif_inject": "fused_inject",
           "bucket_pack": "bucket_pack", "fused_drain": "fused_drain",
           "lif_step": "lif_step", "merge_sort_words": "merge_sort",
           "merge_sort": "merge_sort", "flash_attention": "flash_attention",
           "flash_attention_bwd": "flash_attention_bwd",
           "ssm_scan": "ssm_scan", "ssm_scan_bwd": "ssm_scan_bwd",
           "ssm_scan_heads_bwd": "ssm_scan_bwd_chunked",
           "ssd_chunked": "ssd_chunked"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory one block may use on Hopper (227 KB).
MAX_SMEM = 232448

launches: dict[str, int] = {name: 0 for name in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}   # (source, symbol) -> function


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it names a CUDA device and none
    is present (entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build_root() -> Path:
    """``build/repro_torch`` of the source checkout the package lies in,
    else the user's cache directory."""
    pkg = Path(__file__).resolve().parents[1]
    root = pkg.parents[1]
    if pkg.parent.name == "src" and (root / "pyproject.toml").exists():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return build_root() / h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels")
    return nvcc


def build(names=SOURCES) -> Path:
    """Compile every missing kernel library, in parallel.  Returns the
    build directory; each ``<name>.log`` holds ``ptxas``'s register and
    shared-memory report."""
    out = build_dir()
    todo = [n for n in names if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def kernel_fn(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of kernel ``name``, its source built
    and loaded on first use, with its ctypes signature set once (the
    function is cached per source and symbol)."""
    src = KERNELS[name]
    fn = _fns.get((src, symbol))
    if fn is not None:
        return fn
    lib = _libs.get(src)
    if lib is None:
        lib = ctypes.CDLL(str(build((src,)) / f"lib{src}.so"))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[src] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _fns[(src, symbol)] = fn
    return fn


def launch(name: str, fn, *args) -> None:
    """Call a C launcher (its last argument is the current stream), raise
    on a non-zero ``cudaGetLastError()`` and count the launch."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = _libs[KERNELS[name]].repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    launches[name] += 1


PROFILER_ACTS = (torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA)


def on_device(event) -> bool:
    """Whether a torch.profiler event ran on the card (a kernel, copy or
    fill)."""
    return str(getattr(event, "device_type", "")).endswith("CUDA")


def profiled(window, where: str, tries: int = 5, expect: str | None = None):
    """``(prof, window())`` from the first of up to ``tries`` torch.profiler
    sessions (CPU and CUDA activities) around ``window`` that recorded
    device activity and, with ``expect`` (a regular expression), a device
    event whose name matches it; raises, naming ``where`` (and the
    pattern), if none did.  Now and then a session records no device
    activity at all, and after a spawned child process that used the card
    nearly every one does (``tools/profiler_probe.py``); a session may
    also record PyTorch's kernels and miss a ctypes kernel of the same
    window.  So ``window`` may run more than once."""
    pattern = re.compile(expect) if expect is not None else None
    for _ in range(tries):
        with torch.profiler.profile(activities=list(PROFILER_ACTS)) as prof:
            out = window()
        names = [e.name for e in prof.events() if on_device(e)]
        if names and (pattern is None
                      or any(pattern.search(n) for n in names)):
            return prof, out
    raise AssertionError(
        f"{where}: torch.profiler recorded no device activity"
        + ("" if pattern is None else f" matching {expect!r}")
        + f" in {tries} sessions")


def card_kernels(fn, tries: int = 5, expect: str | None = None):
    """``fn()``'s result and the names of the CUDA kernels (and copies or
    fills) that one call of it put on the card, from torch.profiler
    (:func:`profiled`, which retries a session without a kernel matching
    ``expect``), after one warm-up call."""
    fn()
    torch.cuda.synchronize()

    def window():
        out = fn()
        torch.cuda.synchronize()
        return out

    prof, out = profiled(window, "card_kernels", tries, expect)
    return out, [e.name for e in prof.events() if on_device(e)]


def graph_ms(fn, iters: int = 20, reps: int = 5, stream=None) -> float:
    """Per-call time with CUDA events over replays of one CUDA graph that
    holds ``iters`` back-to-back calls: the calls run without the host's
    launch gaps, so a short kernel is timed, not its Python wrapper.
    ``stream``: the stream to warm up and capture on (default a new
    one)."""
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * iters)


def build_variant(source: Path) -> tuple[ctypes.CDLL, str]:
    """Another version of a kernel source (an earlier commit's, or a
    variant with the same C entry points) compiled with the port's flags
    and ``csrc`` on its include path, beside the tree's build: the loaded
    library and ptxas's report."""
    source = Path(source).resolve()
    out = build_dir() / "variants"
    out.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    lib = out / f"lib{source.stem}.{tag}.so"
    done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                           str(lib), str(source)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{done.stdout}"
                           f"{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.repro_error_string.argtypes = [ctypes.c_int]
    dll.repro_error_string.restype = ctypes.c_char_p
    return dll, done.stdout + done.stderr


@contextlib.contextmanager
def variant(name: str, dll: ctypes.CDLL):
    """Within the block the wrappers of kernel ``name`` (and of the other
    kernels of its source) launch ``dll``, a :func:`build_variant` of the
    source, instead of the tree's build; their launches count as
    usual."""
    src = KERNELS[name]
    saved_lib = _libs.get(src)
    saved = {key: _fns.pop(key) for key in list(_fns) if key[0] == src}
    _libs[src] = dll
    try:
        yield
    finally:
        for key in [key for key in _fns if key[0] == src]:
            del _fns[key]
        _fns.update(saved)
        if saved_lib is None:
            del _libs[src]
        else:
            _libs[src] = saved_lib


def check(x: torch.Tensor, name: str, dtype, shape) -> int:
    """Validate a kernel argument; returns its data pointer."""
    if not x.is_cuda:
        raise ValueError(f"{name} must lie on a CUDA device, not {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.data_ptr()


P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float
