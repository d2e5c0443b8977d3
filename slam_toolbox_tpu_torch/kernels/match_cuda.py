"""Hand-written CUDA kernels of the matcher and their plain versions.

Counterparts of the three Pallas kernels of
slam_toolbox_tpu/kernels/match_pallas.py and of the roofline ceiling of
the third, scripts/exp_roofline.py:

  scatter_occupancy  <- _scatter_bits          (match_pallas.py :234)
  smear_quantize     <- smear_quantize_parity  (match_pallas.py :394)
  score_windows      <- score_windows          (match_pallas.py :119)
  score_ceiling      <- mk_ceil.kern           (exp_roofline.py :123)

score_ceiling is on no mapping path: it is score_windows' ceiling, the
same data path with compile-time offsets in place of the table, timed
beside it at equal work by chip_smoke.py. score_windows.cu also holds
the head form of the window sums, which forms the match's headings,
rotated tables and lattice origin in the kernel (step_cuda.
score_windows_head, counted under score_windows). The scan step's three
other kernels, which replace no Pallas kernel (ring_points, score_tail,
stream_update), have their wrappers and plain versions in
kernels/step_cuda.py; the solver's two (chain_thomas, the block Thomas
factorization and sweeps, in solver/chain_precond.py; device_loop, the
CUDA-graph WHILE nodes of WhileProgram below); all are built, bound and
counted here.

Each source in ../csrc/ is compiled on first use by its own nvcc process
(all started together) into a shared library with a plain C interface in
the package's build directory, and loaded with ctypes. Every wrapper
checks its arguments, allocates its outputs, launches on PyTorch's current
stream and raises if the launch was refused. A wrapper given CPU tensors
runs the plain PyTorch version instead; given CUDA tensors it launches the
kernel or raises — it never falls back.

LAUNCHES counts, per kernel, the launches made through the wrappers, and
GRID_LAUNCHES the same per (kernel, grid side G), which tells the
sequential matcher's rasters from the loop matcher's. A call made while
a CUDA graph is being captured records the kernel into the graph and
launches nothing, so it is not counted; inside tallied() it is added to
the graph's tally instead, and count_replay(tally, n) counts n replays
of that graph. Launches a thread makes inside uncounted() (warming) are
not counted, whether by a wrapper or by a replay.

The port's CUDA graphs are made here: capture_graph (an eager warm-up on
a side stream, the capture under the process's capture_lock, the tally)
serves the drain's step graph (mapper/streaming.py); Program, a
function of static input buffers captured once and replayed per call
(the matcher's match and exact passes and rasters, the fused loop verify
and the near-chain matches); StatefulProgram, a function that updates
its state in place (the distributed solve's CG chunks, solver/
se2_solver.py CGLoop); and WhileProgram, captured functions joined by
WHILE nodes into one graph (lm_solve's LM and CG loops).

The libraries are built and loaded once per process under a lock, so
threads that reach a kernel first at the same time (a session warming on
a second thread) share one build.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from slam_toolbox_tpu_torch.kernels.rasterize import (
    occupancy_words, scatter_occupancy_plain, smear_quantize_plain,
)
from slam_toolbox_tpu_torch.native import BUILD_DIR
from slam_toolbox_tpu_torch.utils.metrics import stage_timer

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")

KERNELS = ("scatter_occupancy", "smear_quantize", "score_windows",
           "score_ceiling", "ring_points", "score_tail", "stream_update",
           "chain_thomas", "device_loop")
# score_ceiling's compile-time (dx, dy) offsets, as in csrc/score_ceiling.cu
CEIL_OFFSETS = ((612, -35), (-480, 271), (133, 702), (-57, -655),
                (890, 404), (-821, -230), (305, -877), (-214, 515))
# smear_quantize's output tile (rows, columns), as in csrc/smear_quantize.cu
SMEAR_TILE = (32, 124)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]
LAUNCHES = {name: 0 for name in KERNELS}
GRID_LAUNCHES = collections.Counter()
_libs = {}
_build_lock = threading.Lock()
_uncounted = threading.local()
_tally = threading.local()


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    GRID_LAUNCHES.clear()


@contextlib.contextmanager
def uncounted():
    """Launches this thread makes inside the block are not counted."""
    prev = getattr(_uncounted, "on", False)
    _uncounted.on = True
    try:
        yield
    finally:
        _uncounted.on = prev


@contextlib.contextmanager
def tallied():
    """Yields a Counter of (kernel, G) -> the launches this thread records
    into a CUDA graph being captured inside the block: the launches one
    replay of that graph makes."""
    prev = getattr(_tally, "counter", None)
    _tally.counter = collections.Counter()
    try:
        yield _tally.counter
    finally:
        _tally.counter = prev


def count_replay(tally, replays: int = 1) -> None:
    """Count `replays` replays of a graph whose launches tallied() gave."""
    if getattr(_uncounted, "on", False):
        return
    for (name, G), n in tally.items():
        LAUNCHES[name] += n * replays
        GRID_LAUNCHES[name, G] += n * replays


# one CUDA graph capture at a time in a process (warm_async's thread may
# capture while the session's thread reaches its first use); reentrant,
# so a caller can hold it across a cache lookup and the capture
capture_lock = threading.RLock()


def capture_graph(fn, device, warm=None, steps: int = 1,
                  keep_graph: bool = False):
    """`steps` calls of `fn` captured as one CUDA graph on `device`:
    returns (graph, the launches one replay makes (tallied), the last
    call's return value, which lives in the graph's private pool). The
    capture runs on a side stream that first waits for the caller's
    current stream; there `warm()`, if given, runs once eagerly,
    uncounted, so the kernels' libraries load and the CUDA modules
    initialize outside the capture (it must not write what `fn` reads,
    unless `fn` writes it again before reading). The capture runs in
    thread_local mode (another thread's launches do not break it) under
    capture_lock. Unlike torch.cuda.graph it neither synchronizes the
    device nor empties the device and pinned-host caches first: a
    session thread may be copying through pinned memory meanwhile, and
    emptying that cache under it fails. A capture that fails raises.
    With `keep_graph` the graph is kept uninstantiated for
    raw_cuda_graph() (WhileProgram). Timed as the `capture` stage of the
    innermost open span's Stats."""
    with capture_lock, stage_timer(None, "capture"):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        out = None
        with torch.cuda.stream(side):
            if warm is not None:
                with uncounted():
                    warm()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                with tallied() as tally:
                    for _ in range(steps):
                        out = fn()
            finally:
                graph.capture_end()
        cur.wait_stream(side)
    return graph, tally, out


class Program:
    """`fn(**inputs)` as one program on static input buffers: on a card
    captured once as a CUDA graph (capture_graph, warmed on the same
    buffers) and replayed per run, on the CPU run eagerly on the same
    buffers. `fn` returns one tensor and writes none of its inputs, so
    its warm-up leaves them as they were. A graph's output lives in its
    pool and the next replay overwrites it, so run() returns a copy; a
    caller fills the inputs, runs and takes the copy inside one
    `with program.lock:` block, which orders them for threads sharing
    the program. `storage` is the caller's: what the program was
    captured on (a pool's storage) beside its static inputs."""

    def __init__(self, fn, inputs: dict, storage=None):
        self.fn = fn
        self.inputs = inputs
        self.storage = storage
        self.lock = threading.Lock()
        self.replays = 0
        self.capture_s = 0.0
        self.graph = self.tally = self.out = None
        dev = next(iter(inputs.values())).device
        if _on_cuda(dev):
            t0 = time.perf_counter()
            self.graph, self.tally, self.out = capture_graph(
                lambda: fn(**inputs), dev, warm=lambda: fn(**inputs))
            self.capture_s = time.perf_counter() - t0

    def run(self, out=None):
        """One run on the inputs as they stand: the output copied into
        `out`, or into a new tensor."""
        if self.graph is None:
            res = self.fn(**self.inputs)
            return res if out is None else out.copy_(res)
        self.graph.replay()
        self.replays += 1
        count_replay(self.tally)
        return self.out.clone() if out is None else out.copy_(self.out)


class StatefulProgram:
    """`fn(state)` as one program that updates `state` (a dict of
    tensors) in place and reads other static buffers it closes over,
    which the caller writes between runs: on a card captured once as a
    CUDA graph (capture_graph) and replayed per run, on the CPU run
    eagerly on the same buffers. The warm-up runs `fn` on a scratch copy
    of `state`, so it writes nothing that the captured function reads. A
    capture that fails raises; nothing runs eagerly in its place.
    `replays` tallies the runs of the graph."""

    def __init__(self, fn, state: dict):
        self.fn = fn
        self.state = state
        self.replays = 0
        self.capture_s = 0.0
        self.graph = self.tally = None
        dev = next(iter(state.values())).device
        if _on_cuda(dev):
            scratch = {k: v.clone() for k, v in state.items()}
            t0 = time.perf_counter()
            self.graph, self.tally, _ = capture_graph(
                lambda: fn(state), dev, warm=lambda: fn(scratch))
            self.capture_s = time.perf_counter() - t0

    def run(self) -> None:
        if self.graph is None:
            self.fn(self.state)
            return
        self.graph.replay()
        self.replays += 1
        count_replay(self.tally)


class WhileProgram:
    """Loops on the device as one CUDA graph that csrc/device_loop.cu (K10)
    builds: the counterpart of lax.while_loop. `plan` is a list of items
    run in order, each either a function of no argument, captured as a
    CUDA graph (capture_graph, warmed once eagerly on the buffers it
    reads, which it must be free to write) and run as a child-graph node,
    or ("while", flag, plan): a WHILE node that runs `plan` while the
    int64 `flag` (a one-element CUDA tensor that the plan writes) is
    nonzero, tested before the first run. launch() runs the whole on the
    current stream: one cudaGraphLaunch, counted under device_loop, and
    nothing read back. tally[fn] is the kernel launches one run of fn
    records (count_replay). The captured graphs' private pools hold the
    bodies' memory, so the program keeps them until close(). A capture or
    a build that fails raises and keeps nothing; there is no other route."""

    def __init__(self, plan, device):
        self.lib = _lib("device_loop")
        self.graphs, self.tally = [], {}
        self.exec = None
        self.graph = ctypes.c_void_p()
        t0 = time.perf_counter()
        self._raise(self.lib.dl_graph_create(ctypes.byref(self.graph)),
                    "dl_graph_create")
        ok = False
        try:
            self._append(self.graph, plan, device, False)
            ex = ctypes.c_void_p()
            self._raise(self.lib.dl_instantiate(self.graph, ctypes.byref(ex)),
                        "instantiating the loop's graph")
            self.exec = ex
            ok = True
        finally:
            if not ok:
                self.close()
        self.capture_s = time.perf_counter() - t0
        self.launches = 0

    def _raise(self, err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(
                f"device_loop: {what} failed: cudaError {err} "
                f"({self.lib.dl_error_string(err).decode()})")

    def _append(self, graph, plan, device, in_body: bool) -> None:
        lib = self.lib
        for item in plan:
            if callable(item):
                g, self.tally[item], _ = capture_graph(
                    item, device, warm=item, keep_graph=True)
                self.graphs.append(g)
                raw = g.raw_cuda_graph()
                if not isinstance(raw, int):
                    raise TypeError(f"raw_cuda_graph() gave {type(raw)}")
                if in_body:
                    msg = ctypes.create_string_buffer(256)
                    err = lib.dl_check_body(raw, msg, 256)
                    if err:
                        raise RuntimeError(
                            f"device_loop: {item} cannot sit in a WHILE "
                            f"body: it holds {msg.value.decode()} "
                            f"(cudaError {err})")
                self._raise(lib.dl_append_child(graph, raw),
                            "adding a captured graph")
            else:
                kind, flag, body_plan = item
                if kind != "while" or flag.dtype != torch.int64:
                    raise ValueError(f"not a WHILE item: {item}")
                body = ctypes.c_void_p()
                self._raise(lib.dl_append_while(
                    graph, flag.data_ptr(), ctypes.byref(body)),
                    "adding a WHILE node")
                self._append(body, body_plan, device, True)
                self._raise(lib.dl_end_while(body), "closing a WHILE body")

    def launch(self) -> None:
        self._raise(self.lib.dl_launch(self.exec, _stream()), "dl_launch")
        self.launches += 1
        _count("device_loop", 0)

    def close(self) -> None:
        """Destroys the graph and its instance, then lets the captured
        graphs and their pools go."""
        if getattr(self, "graph", None):
            self.lib.dl_destroy(self.graph, self.exec)
            self.graph = self.exec = None
        self.graphs = []

    def __del__(self):
        self.close()


def device_loop_versions() -> dict:
    """The CUDA runtime device_loop.cu was built with and the driver's
    (cudaRuntimeGetVersion, cudaDriverGetVersion)."""
    lib = _lib("device_loop")
    rt, drv = ctypes.c_int(), ctypes.c_int()
    err = lib.dl_versions(ctypes.byref(rt), ctypes.byref(drv))
    if err:
        raise RuntimeError(f"dl_versions failed: cudaError {err}")
    return {"runtime": rt.value, "driver": drv.value}


def _source(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    return os.path.join(home or "/usr/local/cuda", "bin", "nvcc")


def build_kernels(names=KERNELS, force: bool = False) -> float:
    """Compile the named kernels (one nvcc process per source, run in
    parallel) unless a library newer than its source and the headers of
    csrc/ (*.cuh, which the sources include) exists. Writes each compiler
    log (registers, shared memory, spills) next to its library. Returns
    the wall seconds; raises RuntimeError if any build fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    headers = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
               if f.endswith(".cuh")]
    for name in names:
        src, lib = _source(name), _lib_path(name)
        newest = max(os.path.getmtime(f) for f in [src, *headers])
        if (not force and os.path.exists(lib)
                and os.path.getmtime(lib) >= newest):
            continue
        # per process and thread: concurrent builds never share a file
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(name: str):
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build_kernels((name,))
        lib = ctypes.CDLL(_lib_path(name))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ip, pp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
        exports = {
            "scatter_occupancy": {"scatter_occupancy": [p, p, p, f, i, i, p,
                                                        p]},
            "smear_quantize": {"smear_quantize": [p, p, i, i, p, p, p]},
            "score_windows": {
                "score_windows": [p, i, p, p, p, i, i, i, i, p, p, p],
                "score_windows_head": [p, i, p, p, i, p, p, f, f, f, i, i,
                                       i, i, p, p, p, p]},
            "score_ceiling": {"score_ceiling": [p, i, p, p, i, i, i, i, p,
                                                p]},
            "ring_points": {"ring_points": [p, p, i, p, p, i, i, p, p, p, p,
                                            p, p, f, p, p, p, p, p, p, p, p,
                                            p]},
            "score_tail": {"score_tail": [p, i, i, i, p, i, p, p, i, i, p, p,
                                          p, p, p, p, f, f, f, f, i, f, f, f,
                                          f, i, i, i, i, i, i, p, p, p, p]},
            "stream_update": {"stream_update": [p, p, p, p, p, p, p, p, p, p,
                                                p, p, p, p, p, i, i, i, i, f,
                                                p]},
            "chain_thomas": {"chain_factorize": [p, p, p, i, i, p, p, p, p],
                             "chain_apply": [p, p, p, p, p, i, i, p, p]},
            "device_loop": {
                "dl_versions": [ip, ip],
                "dl_check_body": [p, ctypes.c_char_p, i],
                "dl_graph_create": [pp], "dl_append_child": [p, p],
                "dl_append_while": [p, p, pp], "dl_end_while": [p],
                "dl_instantiate": [p, pp], "dl_launch": [p, p],
                "dl_destroy": [p, p]},
        }[name]
        for export, argtypes in exports.items():
            fn = getattr(lib, export)
            fn.restype = i
            fn.argtypes = argtypes
        if name == "device_loop":
            lib.dl_error_string.restype = ctypes.c_char_p
            lib.dl_error_string.argtypes = [i]
        if name == "score_tail":
            set_cluster_query(lib)
        if name == "ring_points":
            lib.ring_points_scratch_bytes.restype = ctypes.c_longlong
            lib.ring_points_scratch_bytes.argtypes = [i, i]
        if name == "smear_quantize":
            lib.smear_scratch_bytes.restype = ctypes.c_longlong
            lib.smear_scratch_bytes.argtypes = [i, i]
        _libs[name] = lib
    return lib


def set_cluster_query(lib) -> None:
    """The argument types of score_tail_clusters (csrc/score_tail.cu) in
    a library built from score_tail.cu."""
    fn = lib.score_tail_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _on_cuda(device: torch.device) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_if(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _count(name: str, G: int) -> None:
    if torch.cuda.is_current_stream_capturing():
        tally = getattr(_tally, "counter", None)
        if tally is not None:
            tally[name, G] += 1
    elif not getattr(_uncounted, "on", False):
        LAUNCHES[name] += 1
        GRID_LAUNCHES[name, G] += 1


# -- K2: binary occupancy stamp ----------------------------------------------
def scatter_occupancy(points, valid, offset, scale: float, G: int):
    """(ceil(G/32), G) int32 packed occupancy (kernels/rasterize.py) of
    `points` (P, 2) f32 under mask `valid` (P,) bool; cell =
    round_half_away((p - offset) * scale). The kernel's launcher
    zero-fills the words on the stream, so the call is one launch."""
    dev = points.device
    P = points.shape[0]
    _check(points, "points", torch.float32, (P, 2), dev)
    _check(valid, "valid", torch.bool, (P,), dev)
    _check(offset, "offset", torch.float32, (2,), dev)
    if not _on_cuda(dev):
        return scatter_occupancy_plain(points, valid, offset, scale, G)
    lib = _lib("scatter_occupancy")
    words = torch.empty((occupancy_words(G), G), dtype=torch.int32,
                        device=dev)
    _raise_if(lib.scatter_occupancy(
        points.data_ptr(), valid.data_ptr(), offset.data_ptr(),
        float(scale), G, P, words.data_ptr(), _stream(),
    ), "scatter_occupancy")
    _count("scatter_occupancy", G)
    return words


# -- K3: separable max-times smear + int8 quantize ---------------------------
def smear_quantize(words, w, G: int, hk: int):
    """(G*G+1,) int8 raster (last cell a zero sink) from the packed
    (ceil(G/32), G) int32 occupancy and the (2*hk+1,) f32 taps `w`.

    The kernel requires taps that are finite, non-negative, symmetric and
    non-increasing outward from the centre (rasterize.check_smear_taps);
    it does not check them, since that would read the device. Matcher
    checks its taps on the host before upload. The plain version, taken
    for CPU tensors, holds for any taps. Where a block's taps and row
    values pass its shared memory (hk above about 823, below G) the
    kernel keeps them in a scratch buffer allocated here
    (smear_scratch_bytes)."""
    dev = words.device
    _check(words, "words", torch.int32, (occupancy_words(G), G), dev)
    _check(w, "w", torch.float32, (2 * hk + 1,), dev)
    if not _on_cuda(dev):
        return smear_quantize_plain(words, w, G, hk)
    lib = _lib("smear_quantize")
    out = torch.empty(G * G + 1, dtype=torch.int8, device=dev)
    nbytes = smear_scratch_bytes(G, hk, lib)
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
               if nbytes else None)
    _raise_if(lib.smear_quantize(
        words.data_ptr(), w.data_ptr(), G, hk, out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), _stream(),
    ), "smear_quantize")
    _count("smear_quantize", G)
    return out


# scratch bytes of smear_quantize's kernel by (G, hk), as its library
# answers (0: the shared-memory instantiation)
_SMEAR_SCRATCH = {}


def smear_scratch_bytes(G: int, hk: int, lib=None) -> int:
    """The scratch smear_quantize's kernel takes at (G, hk): 0 where a
    block's taps and row values fit its shared memory, else a region a
    block (csrc/smear_quantize.cu smear_scratch_bytes); asked once per
    geometry."""
    n = _SMEAR_SCRATCH.get((G, hk))
    if n is None:
        lib = lib or _lib("smear_quantize")
        n = _SMEAR_SCRATCH[G, hk] = int(lib.smear_scratch_bytes(G, hk))
    return n


# -- K1: coarse window sums --------------------------------------------------
def score_windows_plain(grid_flat, G: int, d, cand_x0, cand_y0, ny: int,
                        nx: int, finite):
    """(na, ny, nx) int32: sum over beams b with finite[b] of
    grid[cand_y0 + 2i + d[a,b,1], cand_x0 + 2j + d[a,b,0]], cells outside
    the G x G grid adding 0 (the raw sums of match._score_tensor)."""
    na = d.shape[0]
    dev = grid_flat.device
    cy = cand_y0.to(torch.int64) + 2 * torch.arange(ny, device=dev)
    cx = cand_x0.to(torch.int64) + 2 * torch.arange(nx, device=dev)
    out = torch.empty((na, ny, nx), dtype=torch.int32, device=dev)
    sink = G * G
    for a in range(na):  # one heading at a time bounds the index tensor
        gy = d[a, :, 1].to(torch.int64)[:, None] + cy[None, :]   # (B, ny)
        gx = d[a, :, 0].to(torch.int64)[:, None] + cx[None, :]   # (B, nx)
        oky = (gy >= 0) & (gy < G) & finite[:, None]
        okx = (gx >= 0) & (gx < G)
        ok = oky[:, :, None] & okx[:, None, :]
        flat = torch.where(ok, gy[:, :, None] * G + gx[:, None, :], sink)
        out[a] = grid_flat[flat].to(torch.int32).sum(dim=0)
    return out


def score_windows(grid_flat, G: int, d, cand_x0, cand_y0, ny: int, nx: int,
                  finite):
    """Coarse window sums; see score_windows_plain. cand_x0 / cand_y0 are
    int32 tensors of one element on the grid's device, so the matcher's
    device-side candidate origin needs no host round trip. The kernel's
    launcher zero-fills the sums on the stream, so the call is one ctypes
    crossing and no PyTorch launch. Lattice sides above 65,535, headings
    above 65,535 and offsets past int32 take the kernel's wide
    instantiation."""
    dev = grid_flat.device
    na, B = d.shape[0], d.shape[1]
    _check(grid_flat, "grid_flat", torch.int8, (G * G + 1,), dev)
    _check(d, "d", torch.int32, (na, B, 2), dev)
    _check(cand_x0, "cand_x0", torch.int32, tuple(cand_x0.shape), dev)
    _check(cand_y0, "cand_y0", torch.int32, tuple(cand_y0.shape), dev)
    if cand_x0.numel() != 1 or cand_y0.numel() != 1:
        raise ValueError("cand_x0 / cand_y0 must hold one element")
    _check(finite, "finite", torch.bool, (B,), dev)
    if not _on_cuda(dev):
        return score_windows_plain(grid_flat, G, d, cand_x0, cand_y0, ny,
                                   nx, finite)
    if d.data_ptr() % 8:
        raise ValueError("d: the kernel reads (dx, dy) pairs 8-byte aligned")
    lib = _lib("score_windows")
    out = torch.empty((na, ny, nx), dtype=torch.int32, device=dev)
    _raise_if(lib.score_windows(
        grid_flat.data_ptr(), G, d.data_ptr(), cand_x0.data_ptr(),
        cand_y0.data_ptr(), na, B, ny, nx, finite.data_ptr(),
        out.data_ptr(), _stream(),
    ), "score_windows")
    _count("score_windows", G)
    return out


# -- K4: the window-score ceiling --------------------------------------------
def ceiling_table(na: int, B: int, device) -> torch.Tensor:
    """(na, B, 2) int32 table tiling CEIL_OFFSETS over the beam slots
    s = a * B + b in order (slot s takes offset s mod 8)."""
    offs = torch.tensor(CEIL_OFFSETS, dtype=torch.int32, device=device)
    slots = torch.arange(na * B, device=device) % len(CEIL_OFFSETS)
    return offs[slots].reshape(na, B, 2)


def score_ceiling_plain(grid_flat, G: int, cand_x0, cand_y0, na: int, B: int,
                        ny: int, nx: int):
    """(ny, nx) int32: score_windows_plain on ceiling_table with every beam
    finite, summed over the headings."""
    d = ceiling_table(na, B, grid_flat.device)
    finite = torch.ones(B, dtype=torch.bool, device=grid_flat.device)
    return score_windows_plain(grid_flat, G, d, cand_x0, cand_y0, ny, nx,
                               finite).sum(dim=0, dtype=torch.int32)


def score_ceiling(grid_flat, G: int, cand_x0, cand_y0, na: int, B: int,
                  ny: int, nx: int):
    """The window-score ceiling; see score_ceiling_plain. The kernel is
    score_windows' data path for the na * B slots with the table taken
    out; its launcher zero-fills the sums on the stream, so the call makes
    no PyTorch launch. It is on no mapping path and keeps the limits of
    score_windows' narrow instantiation (lattice sides up to 65,535,
    int32 offsets) and about 2**31 slots."""
    dev = grid_flat.device
    _check(grid_flat, "grid_flat", torch.int8, (G * G + 1,), dev)
    _check(cand_x0, "cand_x0", torch.int32, (1,), dev)
    _check(cand_y0, "cand_y0", torch.int32, (1,), dev)
    if not _on_cuda(dev):
        return score_ceiling_plain(grid_flat, G, cand_x0, cand_y0, na, B,
                                   ny, nx)
    lib = _lib("score_ceiling")
    out = torch.empty((ny, nx), dtype=torch.int32, device=dev)
    _raise_if(lib.score_ceiling(
        grid_flat.data_ptr(), G, cand_x0.data_ptr(), cand_y0.data_ptr(),
        na, B, ny, nx, out.data_ptr(), _stream(),
    ), "score_ceiling")
    _count("score_ceiling", G)
    return out
