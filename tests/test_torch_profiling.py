"""The port's ``utils/profiling.py`` on the CPU: ``summarize_trace`` over a
hand-built Chrome trace of a card's capture (exact sums by category, by
source line and by kernel; ported kernels charged to the ``ops/`` and
``models/`` lines that called their wrappers, a backward kernel to its
forward op's line through the sequence numbers, the optimizer's
``gpu_user_annotation`` span adding nothing; a kernel launch without its
device record refusing the capture outside the warm-up);
``chip_smoke._profile``'s reader against the ``key_averages()`` reader it
replaced, on the same capture, and ``_profile`` taking a refused capture
again; a real CPU trace of one reduced medmamba train step through
``trace`` (JAX's keys, the total against the capture's own
``key_averages()``, every source in the port, each SS2D scan's backward on
its forward's call line); ``StepTimer`` and ``print_trace_summary``
against the JAX package's."""

import json
import re
import types

import numpy as np
import pytest
import torch

import chip_smoke
from medical_image_classification_tpu.utils import profiling as jprof
from medical_image_classification_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)
PKG = "medical_image_classification_tpu_torch"
BASE_NS = 1_000_000_000
MAIN, BWD, DEV = (1, 10), (1, 20), (0, 7)


def _x(cat, name, th, ts, dur, **args):
    return dict(ph="X", cat=cat, name=name, pid=th[0], tid=th[1], ts=ts,
                dur=dur, args=args)


def _py(name, ts, dur, th=MAIN):
    return _x("python_function", name, th, ts, dur)


def _launch(ts, corr, th=MAIN, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, th, ts, 5.0, correlation=corr)


def _kernel(name, ts, dur, corr, cat="kernel"):
    return _x(cat, name, DEV, ts, dur, correlation=corr)


SCAN_FWD = ("void (anonymous namespace)::scan_fwd_chunk_kernel<"
            "__nv_bfloat16, 16, false>(__nv_bfloat16 const*, float*)")
MIXER = ("void stl_mixer::mixer_fwd_rows_kernel<__nv_bfloat16, 128>("
         "__nv_bfloat16 const*)")
ADD = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
       "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)")
ADAM = ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
        "<at::native::(anonymous namespace)::TensorListMetadata<4> >(int)")
COPY = "Memcpy DtoD (Device -> Device)"
SCAN_BWD = ("void (anonymous namespace)::bwd_local_kernel<__nv_bfloat16, "
            "16>(__nv_bfloat16 const*)")
GRAM = ("void ssd_walk::tiles::gram_kernel<__nv_bfloat16, ssd_walk::"
        "DirsLayout<__nv_bfloat16> >(__nv_bfloat16 const*)")
REDUCE = ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<"
          "float> >(float)")
MEMSET = "Memset (Device)"


def _fixture(warmup=True):
    """A card's capture in miniature: a scan forward through its op and
    wrapper, an STL mixer forward, an elementwise kernel from an operator,
    the optimizer (a user annotation on the host, a gpu_user_annotation
    span over its kernel on the device), a memcpy, the scan's and an SSD
    gram pass's backward on the autograd thread, a kernel launched outside
    the port, one with no launch in the trace, and one of the capture's
    own warm-up (counted by nothing).  Returns (trace, its call sites)."""
    ev = [
        dict(ph="M", name="process_name", pid=1, tid=0,
             args=dict(name="python")),
        _py(f"{PKG}/train/train_step.py(89): step_fn", 0, 2000),
        # the scan forward: ops/ss2d.py -> kernels/ -> the launch
        _py(f"{PKG}/ops/ss2d.py(173): scan_dir", 100, 300),
        _py(f"{PKG}/kernels/selective_scan_fwd.py(330): scan_folded_fwd",
            110, 280),
        _py("torch/autograd/function.py(571): apply", 120, 260),
        _x("cpu_op", "ScanFolded", MAIN, 125, 250,
           **{"Sequence number": 7, "Fwd thread id": 0}),
        _x("cpu_op", "mic_torch::selective_scan_fwd", MAIN, 140, 100),
        _py(f"{PKG}/kernels/_dispatch.py(56): call", 150, 50),
        _launch(160, 101),
        _kernel(SCAN_FWD, 200, 40, 101),
        # the STL mixer from a models/ line
        _py(f"{PKG}/models/ss2d_modules.py(210): forward", 500, 300),
        _py(f"{PKG}/kernels/stl_mixer.py(260): stl_mixer", 520, 200),
        _py(f"{PKG}/kernels/_dispatch.py(56): call", 540, 50),
        _launch(550, 102),
        _kernel(MIXER, 600, 60, 102),
        # an operator (no Python call out of the frame)
        _py(f"{PKG}/models/common.py(300): forward", 900, 100),
        _x("cpu_op", "aten::add", MAIN, 910, 30),
        _launch(915, 103),
        _kernel(ADD, 950, 10, 103),
        # the SSD's forward op, whose backward runs the gram pass below
        _py(f"{PKG}/ops/ss2d.py(230): ss2d_core_ssd", 1010, 80),
        _py(f"{PKG}/kernels/ssd_fused_dirs.py(370): ssd_fused_dirs", 1015,
            70),
        _x("cpu_op", "SSDFusedDirs", MAIN, 1020, 40,
           **{"Sequence number": 9, "Fwd thread id": 0}),
        # the optimizer
        _py(f"{PKG}/train/train_step.py(135): _update", 1200, 700),
        _py("torch/optim/optimizer.py(480): wrapper", 1210, 600),
        _x("user_annotation", "Optimizer.step#Adam.step", MAIN, 1220, 500),
        _launch(1300, 104),
        _kernel(ADAM, 1400, 80, 104),
        _x("gpu_user_annotation", "Optimizer.step#Adam.step", DEV, 1390,
           100),
        _launch(1850, 105, name="cudaMemcpyAsync"),
        _kernel(COPY, 1860, 2, 105, cat="gpu_memcpy"),
        # the autograd thread
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "ScanFoldedBackward", BWD, 2100, 400,
           **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("cpu_op", "ScanFoldedBackward", BWD, 2105, 390,
           **{"Sequence number": 7, "Fwd thread id": 1}),
        _py(f"{PKG}/kernels/selective_scan_bwd.py(318): backward", 2110,
            380, th=BWD),
        _launch(2200, 106, th=BWD),
        _kernel(SCAN_BWD, 2300, 120, 106),
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "SSDFusedDirsBackward", BWD, 2600, 200,
           **{"Sequence number": 9, "Fwd thread id": 1}),
        _launch(2650, 107, th=BWD),
        _kernel(GRAM, 2700, 30, 107),
        # outside the port, and a kernel whose launch the trace lacks
        _launch(2500, 108),
        _kernel(REDUCE, 2900, 5, 108),
        _kernel(MEMSET, 2950, 1, 999, cat="gpu_memset"),
    ]
    if warmup:      # the capture's own warm-up: its kernel in the span
        ev += [_x("gpu_user_annotation", tprof.WARMUP, DEV, 3000, 20),
               _kernel(ADD, 3005, 7, 109), _launch(3001, 109)]
    ev += [
        dict(ph="s", id=108, pid=1, tid=10, ts=2500, cat="ac2g",
             name="ac2g"),
    ]
    callers = {str(round(ts * 1000) + BASE_NS): [f"{PKG}/{f}", line, fn]
               for ts, f, line, fn in (
                   (110, "ops/ss2d.py", 174, "scan_dir"),
                   (520, "models/ss2d_modules.py", 224, "forward"),
                   (1015, "ops/ss2d.py", 262, "ss2d_core_ssd"),
                   (1210, "train/train_step.py", 141, "_update"))}
    return dict(traceEvents=ev, baseTimeNanoseconds=BASE_NS), callers


# each device event: (us, category, source)
WANT = {
    SCAN_FWD: (40, "port row 1: scan", "ops/ss2d.py:174 (scan_dir)"),
    MIXER: (60, "port row 8: STL mixer",
            "models/ss2d_modules.py:224 (forward)"),
    ADD: (10, "elementwise", "models/common.py:300 (forward)"),
    ADAM: (80, "elementwise", "train/train_step.py:141 (_update)"),
    COPY: (2, "memcpy/memset", "train/train_step.py:135 (_update)"),
    SCAN_BWD: (120, "port row 2: scan backward",
               "ops/ss2d.py:174 (scan_dir)"),
    GRAM: (30, "port row 5b: SSD dirs backward",
           "ops/ss2d.py:262 (ss2d_core_ssd)"),
    REDUCE: (5, "reduction/norm", "?"),
    MEMSET: (1, "memcpy/memset", "?"),
}


def _write(tmp_path, tr, callers, stem="host.1.2"):
    with open(tmp_path / f"{stem}{tprof.TRACE_SUFFIX}", "w") as f:
        json.dump(tr, f)
    with open(tmp_path / f"{stem}{tprof.CALLERS_SUFFIX}", "w") as f:
        json.dump(callers, f)


def _sums(key):
    out = {}
    for us, cat, src in WANT.values():
        k = {"category": cat, "source": src}[key]
        out[k] = out.get(k, 0.0) + us
    return out


@pytest.mark.parametrize("steps", [1, 2])
def test_summarize_trace_attributes_the_fixture_exactly(tmp_path, steps):
    _write(tmp_path, *_fixture())
    s = tprof.summarize_trace(str(tmp_path), steps=steps)
    assert list(s) == ["total_ms", "by_category", "by_source", "by_op"]
    ms = lambda us: us / 1e3 / steps
    assert s["total_ms"] == pytest.approx(ms(348), abs=1e-12)
    assert s["by_op"] == pytest.approx(
        {k: ms(v[0]) for k, v in WANT.items()}, abs=1e-12)
    assert s["by_category"] == pytest.approx(
        {k: ms(v) for k, v in _sums("category").items()}, abs=1e-12)
    assert s["by_source"] == pytest.approx(
        {k: ms(v) for k, v in _sums("source").items()}, abs=1e-12)
    # sorted by time, as the JAX result
    assert list(s["by_op"].values()) == sorted(s["by_op"].values(),
                                               reverse=True)


def test_summarize_trace_without_call_sites_takes_first_lines(tmp_path):
    """A capture without its call sites charges each frame to its
    function's first line (the Chrome trace's own naming)."""
    tr, _ = _fixture()
    _write(tmp_path, tr, {})
    s = tprof.summarize_trace(str(tmp_path))
    assert s["by_source"]["ops/ss2d.py:173 (scan_dir)"] == \
        pytest.approx(0.160)
    assert s["by_source"]["train/train_step.py:135 (_update)"] == \
        pytest.approx(0.082)


def test_newest_trace_is_read(tmp_path):
    import os
    import time
    tr, callers = _fixture()
    _write(tmp_path, tr, callers, stem="a.1.1")
    tr2 = dict(traceEvents=[_kernel(REDUCE, 0, 7, 1)],
               baseTimeNanoseconds=BASE_NS)
    _write(tmp_path, tr2, {}, stem="b.1.2")
    later = time.time() + 10
    os.utime(tmp_path / f"b.1.2{tprof.TRACE_SUFFIX}", (later, later))
    assert tprof.summarize_trace(str(tmp_path))["total_ms"] == \
        pytest.approx(0.007)
    with pytest.raises(FileNotFoundError):
        tprof.summarize_trace(str(tmp_path / "none"))


def _key_averages_of(tr):
    """The fixture as ``key_averages()`` aggregates a capture: a row a
    name, CPU ops and user annotations with CPU time, each device event
    name's row with none, the gpu_user_annotation span a row of its own
    with no CPU time."""
    rows = {}
    for e in tr["traceEvents"]:
        if e.get("ph") != "X" or e["cat"] in ("python_function",
                                              "cuda_runtime"):
            continue
        dev = e["cat"] in tprof.DEVICE_CATS + ("gpu_user_annotation",)
        key = (e["name"], dev)
        r = rows.setdefault(key, types.SimpleNamespace(
            key=e["name"], count=0, cpu_time_total=0.0,
            device_time_total=0.0,
            is_user_annotation=e["cat"] == "gpu_user_annotation"))
        r.count += 1
        if dev:
            r.device_time_total += e["dur"]
        else:
            r.cpu_time_total += e["dur"]
    return list(rows.values())


def test_chip_smoke_profile_reader_equals_the_key_averages_reader():
    """One capture, both of chip_smoke's readers: the same device rows
    (name, launches, device us), hence the same sums that _step_profile
    and _walk_split take; the optimizer's span in neither.  (The capture
    is one ``_profile`` makes: ``trace``'s warm-up is not in it.)"""
    tr, callers = _fixture(warmup=False)
    new = chip_smoke._rows_of_trace(dict(tr, callers=callers))
    old = [r for r in chip_smoke._rows_of_key_averages(_key_averages_of(tr))
           if r["cpu_us"] == 0.0]
    key = lambda rows: sorted((r["name"], r["count"], r["device_us"],
                               r["cpu_us"]) for r in rows)
    assert key(new) == key(old)
    assert sum(r["device_us"] for r in new) == 348
    assert "Optimizer.step#Adam.step" not in {r["name"] for r in new}


def _tiny_medmamba_step():
    from medical_image_classification_tpu_torch.models import create_model
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        make_train_step)
    model = create_model("medmamba", 8, drop_path_rate=0.0,
                         depths=(1, 1), dims=(16, 32), d_state=4,
                         generator=torch.Generator().manual_seed(0))
    opt = make_optimizer("adam", model.named_parameters())
    step = make_train_step(model, opt, make_lr_scheduler(
        opt, make_schedule("constant", 1e-4)))
    imgs = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 16, 16, 3), dtype=np.uint8))
    labels = torch.arange(2) % 8
    return lambda: step(imgs, labels)


def test_real_cpu_trace_of_a_medmamba_step(tmp_path):
    """One reduced medmamba train step through ``trace``: JAX's keys, the
    total within 1% of the capture's own key_averages() (the CPU ops'
    self time), every counted op's source in the port, and each of the
    eight scans' (4 directions x 2 blocks) forward and backward on
    ops/ss2d.py's call of the scan."""
    step = _tiny_medmamba_step()
    step()
    with tprof.trace(str(tmp_path)) as prof:
        step()
    s = tprof.summarize_trace(str(tmp_path))
    assert list(s) == ["total_ms", "by_category", "by_source", "by_op"]
    tr = tprof.load_trace(str(tmp_path))
    frames = {e["name"] for e in tr["traceEvents"]
              if e.get("cat") == "python_function"}
    # key_averages() of a capture with stacks also has a row a Python
    # frame; the ops' rows are the rest
    ka = sum(e.self_cpu_time_total for e in prof.key_averages()
             if e.key not in frames) / 1e3
    assert abs(s["total_ms"] - ka) <= 0.01 * ka, (s["total_ms"], ka)
    assert "?" not in s["by_source"]
    recs = tprof.attribute(tr)
    assert all(re.match(r"^(\w+/)+\w+\.py:\d+ \([\w<>]+\)$", r["source"])
               for r in recs)
    call = [n for n, line in enumerate(open(
        f"{PKG}/ops/ss2d.py").read().splitlines(), 1)
        if "return scan_folded_fwd(xj, dts" in line]
    assert len(call) == 1
    want = f"ops/ss2d.py:{call[0]} (scan_dir)"
    fwd = [r for r in recs if r["name"] == "mic_torch::selective_scan_fwd"]
    bwd = [r for r in recs if r["name"] == "ScanFoldedBackward"]
    assert len(fwd) == len(bwd) == 4 * 2          # 4 directions, 2 blocks
    assert {r["source"] for r in fwd + bwd} == {want}
    assert all(r["backward"] for r in bwd)
    assert s["by_category"]["port row 1: scan"] > 0
    assert s["by_category"]["port row 2: scan backward"] > 0


def test_step_timer_matches_jax(monkeypatch):
    import time
    clock = iter([100.0, 102.5, 104.0, 104.0, 110.0])
    stamps = list(clock)
    out = []
    for mod in (jprof, tprof):
        it = iter(stamps)
        monkeypatch.setattr(time, "time", lambda: next(it))
        timer = mod.StepTimer(10)
        out.append([timer.step(), timer.step(3), timer.step(0),
                    timer.step(6)])
    assert out[0] == out[1]
    assert out[1][0] == "1/10 (0.40 it/s, ETA 22s)"


def test_print_trace_summary_matches_jax(capsys):
    s = {"total_ms": 12.3456, "by_category": {"a": 7.0, "b": 5.3456},
         "by_source": {f"f.py:{i} (g)": 1.0 / (i + 1) for i in range(20)},
         "by_op": {"k": 12.3456}}
    texts = []
    for mod in (jprof, tprof):
        mod.print_trace_summary(s, top=15)
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]


def test_profile_scripts_and_trace_ops_on_the_cpu(tmp_path, monkeypatch,
                                                  capsys):
    """profile_step's and profile_fusion_step's main() with --device cpu at
    a tiny size (the models shrunk in the scripts' namespaces): a summary
    with JAX's keys and sources in the port, printed; then trace_ops' main()
    on profile_step's capture, its rows, --cat and --diff of the capture
    with itself (no change)."""
    from medical_image_classification_tpu_torch.models import create_model
    from medical_image_classification_tpu_torch.models.registry import (
        create_fusion_model)
    from medical_image_classification_tpu_torch.scripts import (
        profile_fusion_step, profile_step, trace_ops)
    monkeypatch.setattr(profile_step, "create_model", lambda name, n, **kw:
                        create_model(name, n, depths=(1, 1), dims=(16, 32),
                                     d_state=4, drop_path_rate=0.0, **kw))
    monkeypatch.setattr(
        profile_fusion_step, "create_fusion_model", lambda name, **kw:
        create_fusion_model(name, depths=(1, 1), depths_decoder=(1, 1),
                            dims=(16, 32), dims_decoder=(32, 16), **kw))
    step_dir = str(tmp_path / "step")
    s = profile_step.main(profile_step.parse_args(
        ["--batch", "2", "--size", "16", "--steps", "1", "--logdir",
         step_dir, "--device", "cpu"]))
    assert list(s) == ["total_ms", "by_category", "by_source", "by_op"]
    assert s["total_ms"] > 0 and "?" not in s["by_source"]
    assert "== device op time:" in capsys.readouterr().out
    f = profile_fusion_step.main(profile_fusion_step.parse_args(
        ["--model", "fusionmamba", "--size", "32", "--steps", "1",
         "--logdir", str(tmp_path / "fusion"), "--device", "cpu"]))
    assert f["total_ms"] > 0 and "?" not in f["by_source"]
    capsys.readouterr()
    rows = trace_ops.main(trace_ops.parse_args(
        [step_dir, "--steps", "1", "--top", "5", "--device", "cpu"]))
    assert len(rows) == 5
    assert rows[0][0] == max(r[0] for r in rows)
    assert all(r[2] != "?" for r in rows)
    gemm = trace_ops.main(trace_ops.parse_args(
        [step_dir, "--steps", "1", "--cat", "gemm", "--device", "cpu"]))
    assert gemm and all("gemm" in r[1] for r in gemm)
    diff = trace_ops.main(trace_ops.parse_args(
        [step_dir, "--diff", step_dir, "--steps", "1", "--steps2", "1",
         "--device", "cpu"]))
    assert all(d == 0.0 for d, *_ in diff)
    assert "delta 0.00" in capsys.readouterr().out


@pytest.mark.parametrize("where", ["outside", "inside"])
def test_lost_device_records_refuse_the_capture(tmp_path, where):
    """A kernel launch with no device record of its correlation id: outside
    the warm-up span the capture is refused (its sums would be short);
    inside it, it is the warm-up's to lose, and the sums are the
    fixture's."""
    tr, callers = _fixture()
    ts = 3500 if where == "outside" else 3010
    tr["traceEvents"] += [
        _x("user_annotation", tprof.WARMUP, MAIN, 2995, 30),
        _launch(ts, 110, name="cuLaunchKernel"),
        # a memcpy's call and a memset with no launch are not kernel
        # launches
        _launch(ts + 1, 111, name="cudaMemcpyAsync")]
    ev = [e for e in tr["traceEvents"] if e.get("ph") == "X"]
    assert tprof.lost_launches(ev) == (where == "outside")
    _write(tmp_path, tr, callers)
    if where == "outside":
        with pytest.raises(tprof.LostRecords, match="1 kernel launches"):
            tprof.summarize_trace(str(tmp_path))
        with pytest.raises(tprof.LostRecords):
            chip_smoke._rows_of_trace(dict(tr, callers=callers))
    else:
        assert tprof.summarize_trace(str(tmp_path))["total_ms"] == \
            pytest.approx(0.348, abs=1e-12)


@pytest.mark.parametrize("lost", [0, 2, 3])
def test_chip_smoke_profile_takes_a_short_capture_again(monkeypatch, lost):
    """chip_smoke._profile: a capture whose reader refuses it (a launch
    without its device record) is taken again, up to three captures; the
    rows of the first whole one, else the refusal."""
    calls, reads = [], []

    def read(tr):
        reads.append(tr)
        if len(reads) <= lost:
            raise tprof.LostRecords("short")
        return [dict(name="k", count=1, device_us=1.0, cpu_us=0.0)]

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "_rows_of_trace", read)
    fn = lambda: calls.append(1)
    if lost < 3:
        assert chip_smoke._profile(fn)[0]["name"] == "k"
    else:
        with pytest.raises(tprof.LostRecords):
            chip_smoke._profile(fn)
    assert len(reads) == min(lost + 1, 3)
    assert len(calls) == 1 + len(reads)       # the warm-up call, a capture's
