"""Profiling: torch.profiler traces, device time by category, by source
line and by kernel, and step timing.

Port of ``medical_image_classification_tpu/utils/profiling.py``: ``trace``
(a capture of a few steps), ``StepTimer``, ``summarize_trace`` (ms a step
by category, by source line and by op, the JAX result's keys) and
``print_trace_summary``.  The JAX version reads XLA's ``hlo_category`` and
``source`` off each device op; a torch trace has neither, so here:

- **What counts.** Device activity only: kernels, memcpy and memset.  A
  ``gpu_user_annotation`` span (torch draws one over the optimizer's
  kernels) is never summed: its kernels are already counted; the kernels
  of ``trace``'s own warm-up (inside the span ``WARMUP``) count nothing.
  A trace with no device activity (a CPU run) counts the CPU ops' self
  time instead (an op's time less its direct children's, ops and Python
  frames).  A capture in which a kernel launch outside ``WARMUP`` has no
  device record (tied by ``correlation``) is refused (``LostRecords``):
  its sums would be short.
- **by_category**, the fixed map ``CATEGORIES``: the port's own kernels
  (``csrc/``) by row of the kernel table (PERF.md), forward and backward
  apart; cuBLAS / cuDNN GEMMs and convolutions; elementwise; reductions
  and norms; copies (layout, casts, cat, pad); memcpy / memset; other.
- **by_source**, ``file:line (function)`` of the innermost frame of the
  port package (path below the package) that led to the launch: a device
  event is tied to its launch (``cudaLaunchKernel``, ``cuLaunchKernel``,
  ``cudaMemcpyAsync``, ...) by the trace's ``correlation`` id, and the
  launch to the Python frames around it on its thread.  Frames in
  ``kernels/`` are walked out of, so that a hand kernel is charged to the
  ``ops/`` or ``models/`` line that called its wrapper.  The line is the
  one that made the call out of that frame, which ``trace`` records beside
  the capture (``*.callers.json``: torch's own trace names a frame by its
  function's first line); where no call leaves the frame (an operator such
  as ``@`` or ``+`` on tensors), or the record is missing, the function's
  first line.  A backward op runs on the autograd engine's thread, with no
  frame of the model: it is mapped to the forward op of the same sequence
  number (``Sequence number``, ``Fwd thread id`` > 0 on the backward op),
  and its kernels take that op's source line, as JAX's transposed ops keep
  their primal's ``source``.  "?" where no frame of the port is found.
- **by_op**, the kernel's (or, on the CPU, the op's) name.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import gzip
import json
import os
import re
import socket
import time
from typing import Iterator

PACKAGE = "medical_image_classification_tpu_torch"
TRACE_SUFFIX = ".pt.trace.json"
CALLERS_SUFFIX = ".callers.json"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The annotation over ``warm_up``'s launches: the first kernel launches of
# a capture can lose their device records (on an H100 up to a few tens,
# more the longer the process has run), so ``trace`` makes its own first
# and nothing counts the device events inside this span.
WARMUP = "profiling.trace warm-up"
WARMUP_LAUNCHES = 256
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OP_CATS = ("cpu_op", "user_annotation")

# The port's kernels by row of PERF.md's table: (label, name patterns);
# the first row whose pattern a kernel's name holds wins.  The SSD walk's
# passes are shared by rows 5, 6 and 7b and told apart by their layout
# type; its gram pass (``ssd_walk::tiles::gram_kernel``) runs in both the
# forward and the backward of rows 5 and 6, and takes the row of the
# context it was launched in (``_GRAM``).
PORT_ROWS = (
    ("port row 1: scan", ("scan_fwd_chunk_kernel",
                          "chunk_carry_kernel<false>")),
    ("port row 2: scan backward", ("bwd_local_kernel", "bwd_final_kernel",
                                   "bwd_sum_kernel",
                                   "chunk_carry_kernel<true>")),
    ("port row 3: v1 scan", ("scan_v1_fwd_kernel",)),
    ("port row 4: v1 scan backward", ("scan_v1_bwd_kernel",)),
    ("port row 5: SSD dirs", ("ssd_walk::fwd::", "DirsLayout")),
    ("port row 5b: SSD dirs backward", ("ssd_walk::bwd::", "DirsLayout")),
    ("port row 6: SSD fused", ("ssd_walk::fwd::", "FlatLayout")),
    ("port row 6b: SSD fused backward", ("ssd_walk::bwd::", "FlatLayout")),
    ("port row 7: Y_diag", ("ssd_ydiag::rows_kernel",)),
    ("port row 7b: Y_diag backward", ("ssd_ydiag::cols_kernel", "YDiagLayout",
                                      "f32::grad_kernel", "f32::dcb_kernel")),
    ("port row 8: STL mixer", ("stl_mixer::mixer_fwd",)),
    ("port row 8b: STL mixer backward", ("stl_mixer::mixer_bwd",)),
    ("port row 9: STF gate", ("stf_zgate::zgate_fwd",)),
    ("port row 9b: STF gate backward", ("stf_zgate::zgate_bwd",)),
    ("port row 10: calibration", ("calib_kernel",)),
)
_GRAM = "ssd_walk::tiles::gram_kernel"
# Rows 5-6's patterns name a pass namespace and a layout: both must hold.
_BOTH = ("ssd_walk::fwd::", "ssd_walk::bwd::")

GEMM = "gemm/conv (cuBLAS, cuDNN)"
ELEMENTWISE = "elementwise"
REDUCTION = "reduction/norm"
COPY = "copy (layout, cast, cat, pad)"
MEMORY = "memcpy/memset"
OTHER = "other"
CATEGORIES = tuple(r[0] for r in PORT_ROWS) + (GEMM, ELEMENTWISE, REDUCTION,
                                               COPY, MEMORY, OTHER)

# Library kernels by name: cuBLAS's and cuDNN's by the libraries' naming,
# torch's own (``at::native::...``, and the softmax kernels outside that
# namespace) by what they compute.
_COPY_PATS = ("copy_kernel", "CatArrayBatchedCopy", "constant_pad",
              "reflection_pad", "replication_pad", "transpose", "permute")
_REDUCE_PATS = ("reduce_kernel", "norm", "Norm", "softmax", "Softmax",
                "GammaBeta", "welford", "Welford", "scan_innermost_dim",
                "scan_outer_dim", "cumsum", "batch_norm")
_ELEMENTWISE_PATS = ("elementwise", "multi_tensor_apply", "triu_tril",
                     "index_", "scatter", "gather", "Functor", "where",
                     "fill")
_GEMM_PATS = ("gemm", "gemv", "xmma", "nvjet", "cutlass", "cublas", "cudnn",
              "conv2d", "dgrad", "wgrad", "fprop", "convolve", "nhwc",
              "tensorTransform", "dot_kernel", "scal_kernel", "splitK",
              # cuDNN's FFT convolutions
              "fft", "flip_filter", "pointwise_mult_and_sum")
# the CPU ops of a trace without device activity, by aten name
_CPU_GEMM = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
             "aten::matmul", "aten::linear", "aten::conv", "aten::_conv",
             "aten::convolution", "aten::mkldnn_convolution", "aten::einsum")
_CPU_COPY = ("aten::copy_", "aten::to", "aten::_to_copy", "aten::cat",
             "aten::clone", "aten::contiguous", "aten::constant_pad_nd",
             "aten::pad", "aten::flip", "aten::stack")
_CPU_REDUCE = ("aten::sum", "aten::mean", "aten::var", "aten::std",
               "aten::norm", "aten::softmax", "aten::_softmax",
               "aten::log_softmax", "aten::_log_softmax", "aten::layer_norm",
               "aten::native_layer_norm", "aten::batch_norm",
               "aten::native_batch_norm", "aten::cumsum", "aten::max",
               "aten::amax", "aten::argmax", "aten::logsumexp")
_CPU_PORT = {f"mic_torch::{op}_{way}": label for op, way, label in (
    ("selective_scan", "fwd", "port row 1: scan"),
    ("selective_scan", "bwd", "port row 2: scan backward"),
    ("ssd_fused_dirs", "fwd", "port row 5: SSD dirs"),
    ("ssd_fused_dirs", "bwd", "port row 5b: SSD dirs backward"),
    ("ssd_fused", "fwd", "port row 6: SSD fused"),
    ("ssd_fused", "bwd", "port row 6b: SSD fused backward"),
    ("ssd_ydiag", "fwd", "port row 7: Y_diag"),
    ("ssd_ydiag", "bwd", "port row 7b: Y_diag backward"),
    ("stl_mixer", "fwd", "port row 8: STL mixer"),
    ("stl_mixer", "bwd", "port row 8b: STL mixer backward"),
    ("stf_zgate", "fwd", "port row 9: STF gate"),
    ("stf_zgate", "bwd", "port row 9b: STF gate backward"))}


def category(name: str, backward: bool = False, device: bool = True) -> str:
    """The ``CATEGORIES`` entry of a device event (or, with ``device``
    False, of a CPU op) named ``name``; ``backward``: it was launched
    inside a backward op (only the SSD walk's shared gram pass needs it)."""
    if not device:
        if name in _CPU_PORT:
            return _CPU_PORT[name]
        for pats, cat in ((_CPU_GEMM, GEMM), (_CPU_COPY, COPY),
                          (_CPU_REDUCE, REDUCTION)):
            if name in pats:
                return cat
        return OTHER
    if name.startswith(("Memcpy", "Memset")):
        return MEMORY
    if _GRAM in name:
        layout = "DirsLayout" if "DirsLayout" in name else "FlatLayout"
        name = ("ssd_walk::bwd::" if backward else "ssd_walk::fwd::") + layout
    for label, pats in PORT_ROWS:
        if pats[0] in _BOTH:
            if all(p in name for p in pats):
                return label
        elif any(p in name for p in pats):
            return label
    if "at::native::" not in name and any(p in name for p in _GEMM_PATS):
        return GEMM
    for pats, cat in ((_COPY_PATS, COPY), (_REDUCE_PATS, REDUCTION),
                      (_ELEMENTWISE_PATS, ELEMENTWISE)):
        if any(p in name for p in pats):
            return cat
    return OTHER


# --------------------------------------------------------------------------
# capture


def _trace_paths(logdir: str):
    return sorted(glob.glob(os.path.join(logdir, f"*{TRACE_SUFFIX}")) +
                  glob.glob(os.path.join(logdir, f"*{TRACE_SUFFIX}.gz")),
                  key=os.path.getmtime)


def _callers(prof) -> dict:
    """{start ns of a Python event: [file, line, function] of the frame it
    was called from}, for the events called from a frame of the port: the
    call's line, which the Chrome trace does not keep."""
    from torch._C._profiler import _EventType
    out = {}
    stack = list(prof.profiler.kineto_results.experimental_event_tree())
    while stack:
        e = stack.pop()
        stack.extend(e.children)
        if e.tag in (_EventType.PyCall, _EventType.PyCCall):
            c = e.extra_fields.caller
            if PACKAGE in c.file_name:
                out[str(e.start_time_ns)] = [c.file_name, c.line_number,
                                             c.function_name]
    return out


def warm_up() -> None:
    """Inside a capture on the card: ``WARMUP_LAUNCHES`` tiny kernels under
    the annotation ``WARMUP``, then a sync; they take the device records
    that a capture can lose at its start.  Nothing without a card."""
    import torch
    if not torch.cuda.is_available():
        return
    with torch.profiler.record_function(WARMUP):
        x = torch.zeros(1, device="cuda")
        for _ in range(WARMUP_LAUNCHES):
            x.add_(1.0)
    torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str = "runs/profile") -> Iterator:
    """Capture a trace of the block: CPU ops with their Python stacks and,
    where CUDA is available, its runtime calls and the device's kernels,
    memcpys and memsets.  On exit the Chrome trace (viewable in Perfetto or
    ``chrome://tracing``) is written under ``logdir`` as
    ``<host>.<pid>.<ns>.pt.trace.json``, beside it the call sites
    (``.callers.json``) that ``summarize_trace`` reads.  On the card the
    capture opens with ``warm_up``'s launches.  Yields the
    ``torch.profiler.profile`` (its ``key_averages()`` once the block has
    ended).

    A torch Chrome trace has no cap on its events (the JAX one drops
    device ops past 1M events, hence its host tracers off): three train
    steps of medmamba, medssd or st_ssd at 224², batch 32, stacks on, are
    written and read whole on an H100 (``chip_smoke.py`` phase 39)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, with_stack=True) as prof:
        warm_up()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    base = os.path.join(logdir, f"{socket.gethostname()}.{os.getpid()}."
                                f"{time.time_ns()}")
    prof.export_chrome_trace(base + TRACE_SUFFIX)
    with open(base + CALLERS_SUFFIX, "w") as f:
        json.dump(_callers(prof), f)


class StepTimer:
    """Wall-clock + ETA logging (fusion-train style), as the JAX
    package's."""

    def __init__(self, total_steps: int):
        self.total = total_steps
        self.start = time.time()
        self.done = 0

    def step(self, n: int = 1) -> str:
        self.done += n
        elapsed = time.time() - self.start
        rate = self.done / max(elapsed, 1e-9)
        eta = (self.total - self.done) / max(rate, 1e-9)
        return f"{self.done}/{self.total} ({rate:.2f} it/s, ETA {eta:.0f}s)"


# --------------------------------------------------------------------------
# reading a capture


def load_trace(logdir: str) -> dict:
    """The newest trace under ``logdir`` (``*.pt.trace.json``, or ``.gz``),
    with its call sites under the key ``"callers"`` (empty where the
    capture has none)."""
    paths = _trace_paths(logdir)
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    path = paths[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tr = json.load(f)
    stem = path[:-len(".gz")] if path.endswith(".gz") else path
    side = stem[:-len(TRACE_SUFFIX)] + CALLERS_SUFFIX
    tr["callers"] = {}
    if os.path.exists(side):
        with open(side) as f:
            tr["callers"] = json.load(f)
    return tr


_FRAME = re.compile(r"^(.*)\((\d+)\): (.*)$")


def _port_path(path: str):
    """The path below the port package, or None outside it."""
    i = path.rfind(PACKAGE + "/")
    return None if i < 0 else path[i + len(PACKAGE) + 1:]


def _frame(e):
    """(path below the port package, first line, function) of a Python
    event of the port, else None; parsed once per event."""
    if "_frame" not in e:
        m = _FRAME.match(e["name"])
        rel = _port_path(m.group(1)) if m else None
        e["_frame"] = (None if rel is None
                       else (rel, int(m.group(2)), m.group(3)))
    return e["_frame"]


def _source(chain, callers, base_ns) -> str:
    """``file:line (function)`` of a Python chain (outermost first): the
    innermost port frame outside ``kernels/`` (else the innermost port
    frame), at the line of the call out of it that the chain takes, else
    at its first line."""
    pick = None
    for i in range(len(chain) - 1, -1, -1):
        f = _frame(chain[i])
        if f is None:
            continue
        if pick is None:
            pick = (i, f)
        if not f[0].startswith("kernels/"):
            pick = (i, f)
            break
    if pick is None:
        return "?"
    i, (rel, line, func) = pick
    if i + 1 < len(chain):
        call = callers.get(str(round(chain[i + 1]["ts"] * 1000) + base_ns))
        if call is not None and _port_path(call[0]) == rel:
            line = call[1]
    return f"{rel}:{line} ({func})"


def _chains(intervals, queries):
    """For each query (time, key), the intervals (dicts with ts, dur) that
    contain the time, outermost first: a sweep over the intervals sorted
    by start, keeping a stack of the open ones.  Returns {key: chain}."""
    order = sorted(intervals, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, k = {}, [], 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while k < len(order) and order[k]["ts"] <= t:
            e = order[k]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            stack.append(e)
            k += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= t:
            stack.pop()
        out[key] = [e for e in stack if e["ts"] + e["dur"] > t]
    return out


def _backward_op(ops):
    """The innermost backward op (one with a sequence number whose
    ``Fwd thread id`` is set) of an op chain, or None."""
    for e in reversed(ops):
        a = e.get("args", {})
        if a.get("Fwd thread id", 0) and "Sequence number" in a:
            return e
    return None


class LostRecords(RuntimeError):
    """A capture holds kernel launches without their device records."""


def _spans(ev, cat):
    """(start, end) of every ``WARMUP`` span of category ``cat``."""
    return [(e["ts"], e["ts"] + e["dur"]) for e in ev
            if e.get("cat") == cat and e["name"] == WARMUP]


def lost_launches(ev) -> int:
    """The kernel launches (``cudaLaunchKernel``, ``cuLaunchKernel``, ...)
    among a trace's complete events ``ev`` outside the ``WARMUP`` span
    that no device event names by its ``correlation`` id."""
    recorded = {e.get("args", {}).get("correlation") for e in ev
                if e.get("cat") in DEVICE_CATS}
    warm = _spans(ev, "user_annotation")
    return sum(1 for e in ev if e.get("cat") in LAUNCH_CATS
               and "Launch" in e["name"] and "Kernel" in e["name"]
               and e.get("args", {}).get("correlation") not in recorded
               and not any(a <= e["ts"] <= b for a, b in warm))


def attribute(tr: dict):
    """Every counted event of a loaded trace (``load_trace``) as a record
    {name, category, source, us, backward}: the device events (kernels,
    memcpy, memset; never a ``gpu_user_annotation``) with their launches'
    sources, or, where the trace has none, every CPU op and user
    annotation with its self time.  Raises ``LostRecords`` where a kernel
    launch outside ``WARMUP`` has no device record."""
    ev = [e for e in tr["traceEvents"] if e.get("ph") == "X"]
    lost = lost_launches(ev)
    if lost:
        raise LostRecords(f"{lost} kernel launches of the capture outside "
                          f"the warm-up have no device record: its device "
                          f"time would be short")
    callers = tr.get("callers", {})
    base_ns = int(tr.get("baseTimeNanoseconds", 0))
    warm = _spans(ev, "gpu_user_annotation")
    device = [e for e in ev if e.get("cat") in DEVICE_CATS
              and not any(a <= e["ts"] <= b for a, b in warm)]
    python = collections.defaultdict(list)      # thread -> python events
    th_ops = collections.defaultdict(list)      # thread -> ops
    for e in ev:
        cat = e.get("cat")
        if cat == "python_function":
            python[(e["pid"], e["tid"])].append(e)
        elif cat in OP_CATS:
            th_ops[(e["pid"], e["tid"])].append(e)
    ops = [e for e in ev if e.get("cat") in OP_CATS]

    def sweep(queries, with_ops=True):
        """{key: (python chain, op chain)} of queries {thread: [(t, key)]}."""
        out = {}
        for th, qs in queries.items():
            py = _chains(python.get(th, []), qs)
            oc = _chains(th_ops.get(th, []), qs) if with_ops else {}
            for _, key in qs:
                out[key] = (py[key], oc.get(key, []))
        return out

    # the forward ops by sequence number
    fwd = collections.defaultdict(list)         # seq -> [(ts, op index)]
    for j, e in enumerate(ops):
        a = e.get("args", {})
        if "Sequence number" in a and not a.get("Fwd thread id", 0):
            fwd[a["Sequence number"]].append((e["ts"], j))
    for lst in fwd.values():
        lst.sort()

    def forward_of(bwd):
        """The index of the forward op of backward op ``bwd``: the last one
        of its sequence number that started before it, or None."""
        cands = fwd.get(bwd["args"]["Sequence number"], [])
        i = bisect.bisect_left(cands, (bwd["ts"], -1)) - 1
        return cands[i][1] if i >= 0 else None

    def resolve(chains):
        """{key: (source, backward)}: a backward op's key takes its
        forward op's source where that has one, else its own."""
        need = {}
        for key, (_, oc) in chains.items():
            bwd = _backward_op(oc)
            if bwd is not None:
                j = forward_of(bwd)
                if j is not None:
                    need[key] = j
        missing = collections.defaultdict(list)
        for j in set(need.values()):
            if ("op", j) not in chains:
                e = ops[j]
                missing[(e["pid"], e["tid"])].append((e["ts"], ("op", j)))
        fwd_chains = {**chains, **sweep(missing, with_ops=False)}
        out = {}
        for key, (py, oc) in chains.items():
            src = "?"
            if key in need:
                src = _source(fwd_chains[("op", need[key])][0], callers,
                              base_ns)
            if src == "?":
                src = _source(py, callers, base_ns)
            out[key] = (src, _backward_op(oc) is not None)
        return out

    if device:
        launch = {e["args"]["correlation"]: e for e in ev
                  if e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        queries = collections.defaultdict(list)
        for j, e in enumerate(device):
            L = launch.get(e.get("args", {}).get("correlation"))
            if L is not None:
                queries[(L["pid"], L["tid"])].append(
                    (L["ts"] + L["dur"] / 2, ("dev", j)))
        res = resolve(sweep(queries))
        records = []
        for j, e in enumerate(device):
            src, bwd = res.get(("dev", j), ("?", False))
            records.append(dict(name=e["name"], us=float(e["dur"]),
                                source=src, backward=bwd,
                                category=category(e["name"], bwd)))
        return records
    # no device activity: CPU ops' self time (each op's time less its
    # direct children's on its thread, Python frames among them, as
    # key_averages() takes it)
    child = collections.defaultdict(float)
    queries = collections.defaultdict(list)
    for th, lst in th_ops.items():
        stack = []
        for e in sorted(lst + python.get(th, []),
                        key=lambda e: (e["ts"], -e["dur"])):
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            if stack:
                child[id(stack[-1])] += e["dur"]
            stack.append(e)
    for j, e in enumerate(ops):
        queries[(e["pid"], e["tid"])].append((e["ts"], ("op", j)))
    res = resolve(sweep(queries))
    records = []
    for j, e in enumerate(ops):
        src, bwd = res[("op", j)]
        records.append(dict(name=e["name"],
                            us=float(e["dur"]) - child[id(e)], source=src,
                            backward=bwd,
                            category=category(e["name"], bwd, device=False)))
    return records


def summarize_records(records, steps: int = 1) -> dict:
    """``attribute``'s records as ``summarize_trace``'s result."""
    by_src = collections.Counter()
    by_cat = collections.Counter()
    by_op = collections.Counter()
    total = 0.0
    for r in records:
        d = r["us"] / 1e3 / max(steps, 1)       # ms/step
        total += d
        by_cat[r["category"]] += d
        by_src[r["source"]] += d
        by_op[r["name"]] += d
    return {
        "total_ms": total,
        "by_category": dict(by_cat.most_common()),
        "by_source": dict(by_src.most_common()),
        "by_op": dict(by_op.most_common()),
    }


def summarize_trace(logdir: str, steps: int = 1):
    """Aggregate device time from a ``trace()`` capture: total, and by
    category, by source line and by op (see the module docstring).

    ``steps``: number of identical steps captured inside the trace; all
    durations are divided by it so results read as ms/step.  Raises
    ``LostRecords`` where the capture lost device records.
    """
    return summarize_records(attribute(load_trace(logdir)), steps)


def print_trace_summary(summary, top: int = 15) -> None:
    print(f"== device op time: {summary['total_ms']:.2f} ms/step ==")
    for section in ("by_category", "by_source", "by_op"):
        print(f"\n-- {section} --")
        for k, v in list(summary[section].items())[:top]:
            print(f"{v:8.3f} ms  {k}")
