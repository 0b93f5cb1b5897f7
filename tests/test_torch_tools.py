"""The port's measurement and training tools (``tools/*_torch.py``) against
their JAX counterparts in ``tools/`` on the same inputs: FLOP counts,
anchors, the recipe's commands, JSON keys and line formats, the int8
unit's three arms, and a trace summary's exact sums."""

import ast
import gzip
import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu import graphspec as jax_graphspec
from amyloid_yolo_tpu.pallas import int8_block as jax_int8_block
from amyloid_yolo_tpu_torch import graphspec
from test_tiny_yolo_cfg import TINY_CFG
from torch_port_helpers import jit_compiled, port_mini_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _function(path, name):
    """The ``FunctionDef`` named ``name`` anywhere in the tool at ``path``."""
    with open(os.path.join(TOOLS, path)) as fh:
        tree = ast.parse(fh.read())
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


@pytest.fixture(scope="module")
def mini_cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "mini.cfg"
    path.write_text(graphspec.emit_cfg(port_mini_spec()))
    return str(path)


# -- mfu ------------------------------------------------------------------

def _spec_pair(which, tmp_path):
    if which == "tiny":
        path = tmp_path / "tiny.cfg"
        path.write_text(TINY_CFG)
        return jax_graphspec.from_cfg(str(path)), graphspec.from_cfg(str(path)), 96
    img = int(which)
    return (jax_graphspec.yolov3_spec(num_classes=2, img_size=img),
            graphspec.yolov3_spec(num_classes=2, img_size=img), img)


@pytest.mark.parametrize("which", ["320", "416", "512", "tiny"])
@pytest.mark.parametrize("fn", ["conv_gflops", "train_gflops"])
def test_mfu_counts_equal_jax_tool(which, fn, tmp_path):
    ref, port = _tool("mfu"), _tool("mfu_torch")
    jspec, pspec, img = _spec_pair(which, tmp_path)
    assert getattr(port, fn)(pspec, img) == getattr(ref, fn)(jspec, img)


def test_mfu_prints_no_tpu_number(capsys):
    mfu = _tool("mfu_torch")
    assert mfu.main([]) == 0
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and "GFLOPs/image @ 416²" in out and "%" not in out
    assert mfu.main(["--ms", "20.9", "--int8", "--batch", "32"]) == 0
    line = capsys.readouterr().out.splitlines()[1]
    tflops = mfu.conv_gflops(graphspec.yolov3_spec(num_classes=2), 416) * 32 / 20.9e-3 / 1e3
    assert f"{tflops / mfu.H100_INT8_TOPS * 100:5.2f}% of the H100 int8 peak" in line
    u = mfu.utilization(100.0, 8, 10.0)
    assert u["tflops"] == pytest.approx(80.0)
    assert u["mfu_bf16"] == pytest.approx(80.0 / 989.0)
    assert "v5e" not in open(os.path.join(TOOLS, "mfu_torch.py")).read()


# -- estimate_anchors -----------------------------------------------------

def _label_fixture(tmp_path, n_imgs=6, seed=0):
    """tests/test_estimate_anchors.py's synthetic label set."""
    rng = np.random.RandomState(seed)
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    paths = []
    for i in range(n_imgs):
        p = tmp_path / "images" / f"t{i}.jpg"
        p.write_bytes(b"")
        rows = []
        for _ in range(rng.randint(1, 6)):
            w, h = rng.uniform(0.02, 0.2, 2)
            rows.append(f"{rng.randint(2)} 0.5 0.5 {w:.6f} {h:.6f}")
        (tmp_path / "labels" / f"t{i}.txt").write_text("\n".join(rows) + "\n")
        paths.append(str(p))
    lst = tmp_path / "train.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


def test_anchor_helpers_equal_jax_tool(tmp_path):
    ref, port = _tool("estimate_anchors"), _tool("estimate_anchors_torch")
    assert port.YOLOV3_ANCHORS == ref.YOLOV3_ANCHORS
    for p in ("/d/images/a_b.c.jpg", "/images/x/images/t.png"):
        assert port.label_path(p) == ref.label_path(p)
    lst = _label_fixture(tmp_path)
    wh = port.load_wh(lst, 416)
    np.testing.assert_array_equal(wh, ref.load_wh(lst, 416))
    np.testing.assert_array_equal(port.wh_iou(wh, wh[:5]), ref.wh_iou(wh, wh[:5]))
    for r in range(3):
        c1, m1 = port.kmeans_iou(wh.copy(), 6, np.random.RandomState(r))
        c2, m2 = ref.kmeans_iou(wh.copy(), 6, np.random.RandomState(r))
        np.testing.assert_array_equal(c1, c2)
        assert m1 == m2


def test_anchor_cli_report_and_cfg_equal_jax_tool(tmp_path):
    lst = _label_fixture(tmp_path, seed=1)
    outs = {}
    for tool in ("estimate_anchors", "estimate_anchors_torch"):
        d = tmp_path / tool
        d.mkdir()
        proc = subprocess.run(
            [sys.executable, f"tools/{tool}.py", "--train_list", lst, "--img_size", "512",
             "--k", "9", "--restarts", "2", "--out", str(d / "a.json"), "--emit_cfg",
             str(d / "a.cfg")], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs[tool] = (json.loads((d / "a.json").read_text()), (d / "a.cfg").read_text())
    (rep, cfg), (ref_rep, ref_cfg) = outs["estimate_anchors_torch"], outs["estimate_anchors"]
    assert rep == ref_rep and len(rep["anchors"]) == 9
    assert cfg == ref_cfg
    spec = graphspec.from_cfg(str(tmp_path / "estimate_anchors_torch" / "a.cfg"))
    flat = [a for head in [spec.layers[i].anchors for i in spec.yolo_indices][::-1]
            for a in head]
    assert flat == [tuple(a) for a in rep["anchors"]]


# -- recipe_chain ---------------------------------------------------------

def _dry_run(tool, argv, capsys):
    assert tool.main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("extra", [[], ["--ema_decay", "0.999", "--img_size", "512"],
                                   ["--skip_phase1", "/x/ckpt_5.pt#ema"],
                                   ["--model_def", "a.cfg", "--keep_checkpoints", "3"]])
def test_recipe_dry_run_equals_jax_tool_but_for_names(tmp_path, capsys, extra):
    ref, port = _tool("recipe_chain"), _tool("recipe_chain_torch")
    argv = ["--tag", "t1", "--dry_run", "--out_root", str(tmp_path), *extra]
    want = [l.replace("-m amyloid_yolo_tpu.cli.main train", "-m amyloid_yolo_tpu_torch.cli train")
            for l in _dry_run(ref, argv, capsys)]
    got = _dry_run(port, argv + ["--device", "cpu"], capsys)
    assert len(got) == len(want) and got[-1] == "[recipe_chain] done"
    for g, w in zip(got, want):
        assert g == (w + " --device cpu" if " train " in w else w)


def test_recipe_pick_winner_reads_port_checkpoints(tmp_path):
    port = _tool("recipe_chain_torch")
    ev = tmp_path / "events.jsonl"
    ev.write_text("".join(json.dumps(r) + "\n" for r in [
        {"step": 1, "validation/mAP": 0.2, "validation/mAP_ema": 0.1},
        {"step": 2, "validation/mAP": 0.4, "validation/mAP_ema": 0.5},
        {"step": 3, "validation/mAP": 0.3, "validation/mAP_ema": 0.45}]))
    pick, arm, v, e = port.pick_winner(str(ev), "/ck", ema=False)
    assert (pick, arm, v, e) == ("/ck/yolov3_ckpt_2.pt", "raw", 0.4, 2)
    pick, arm, _, _ = port.pick_winner(str(ev), "/ck", ema=True)
    assert (pick, arm) == ("/ck/yolov3_ckpt_2.pt#ema", "ema")
    assert port.best_of(str(ev), "validation/mAP_ema") == (0.5, 2)


def test_recipe_study_raises(tmp_path):
    port = _tool("recipe_chain_torch")
    with pytest.raises(NotImplementedError, match="not in the repository"):
        port.main(["--tag", "t", "--dry_run", "--study", "--out_root", str(tmp_path)])
    proc = subprocess.run([sys.executable, "tools/recipe_chain_torch.py", "--tag", "t3",
                           "--dry_run", "--out_root", str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "[recipe_chain] done" in proc.stdout, proc.stderr


# -- trace_summary --------------------------------------------------------

def _trace(tmp_path, name="t.json", gz=False):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 100.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 105.0, "dur": 10.0},  # overlaps
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 130.0, "dur": 2.5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 140.0, "dur": 4.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 146.0, "dur": 4.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0.0, "dur": 500.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train/forward", "ts": 90.0,
         "dur": 80.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 120.0},
    ]
    path = tmp_path / name
    data = json.dumps({"traceEvents": events}).encode()
    path.write_bytes(gzip.compress(data) if gz else data)
    return str(path)


@pytest.mark.parametrize("gz", [False, True])
def test_trace_summary_exact_sums_and_busy_share(tmp_path, capsys, gz):
    tool = _tool("trace_summary_torch")
    path = _trace(tmp_path, "t.json.gz" if gz else "t.json", gz)
    assert tool.find_trace_json(str(tmp_path)) == path
    got = tool.summarize(path, top=3)
    assert got["rows"] == [("k_a", 0.02, 2), ("Memcpy HtoD", 0.004, 1), ("Memset", 0.004, 1)]
    assert got["launches"] == 5
    # union: [100, 115] + [130, 132.5] + [140, 144] + [146, 150] over [100, 150]
    assert got["busy_ms"] == pytest.approx(0.0255, abs=1e-12)
    assert got["span_ms"] == pytest.approx(0.05, abs=1e-12)
    assert got["busy_share"] == pytest.approx(0.51, abs=1e-12)
    assert got["idle_share"] == pytest.approx(0.49, abs=1e-12)
    out = capsys.readouterr().out
    assert "busy share 0.5100, idle share 0.4900" in out and "aten::conv2d" not in out
    assert tool.busy_and_span([]) == (0.0, 0.0)
    assert tool.busy_and_span([(0, 4), (1, 2), (6, 7)]) == (5, 7)


def _events(kernels: int, calls: int, annotations: int = 1):
    """A profiler's events: ``kernels`` device records (a copy among them),
    ``calls`` host launch calls, user ranges on the device and other host
    events, none of which count."""
    from types import SimpleNamespace as Ev
    from torch.autograd import DeviceType
    dev = [Ev(device_type=DeviceType.CUDA, is_user_annotation=False,
              name="Memcpy HtoD (Pageable -> Device)" if i == 0 else f"k{i}")
           for i in range(kernels)]
    dev += [Ev(device_type=DeviceType.CUDA, is_user_annotation=True, name="train/forward")
            for _ in range(annotations)]
    names = ("cudaLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
    host = [Ev(device_type=DeviceType.CPU, is_user_annotation=False, name=names[i % 4])
            for i in range(calls)]
    host += [Ev(device_type=DeviceType.CPU, is_user_annotation=False, name=n)
             for n in ("aten::conv2d", "cudaStreamSynchronize", "cudaMemcpy")]
    return dev + host


@pytest.mark.parametrize("traces,unrecorded,tries", [
    ([(10, 10)], 0, 1),                    # complete at once
    ([(7, 10), (10, 10)], 0, 2),           # lost three records, then whole
    ([(8, 10), (7, 10), (9, 10)], 1, 3),   # one call may go unrecorded
    ([(9, 10)], 1, 1),
])
def test_checked_trace_retakes_until_complete(traces, unrecorded, tries):
    tool = _tool("trace_summary_torch")
    taken = iter(traces)

    class Prof:
        def __init__(self, kernels, calls):
            self._events = _events(kernels, calls)

        def events(self):
            return self._events

    prof, counts = tool.checked_trace(lambda: Prof(*next(taken)), unrecorded=unrecorded)
    assert counts == [list(t) for t in traces[:tries]]
    assert tool.record_counts(prof.events()) == traces[tries - 1]


def test_checked_trace_fails_after_its_tries():
    tool = _tool("trace_summary_torch")
    taken = []

    class Prof:
        def events(self):
            return _events(5, 8)

    def take():
        taken.append(1)
        return Prof()

    with pytest.raises(AssertionError, match=r"no trace of 3 .* \[\[5, 8\], \[5, 8\], "
                       r"\[5, 8\]\].*'call: cudaLaunchKernel': 2"):
        tool.checked_trace(take, unrecorded=2, tries=3)
    assert len(taken) == 3
    assert tool.TRACE_TRIES == 8 and tool.trace_complete(5, 8, 3)


# -- serve_bench ----------------------------------------------------------

def _jax_out_keys():
    """The keys of the per-phase dict ``out`` in tools/serve_bench.py."""
    fn = _function("serve_bench.py", "main")
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "out")
    return [k.value for k in node.value.keys]


def test_serve_bench_keys_are_jax_keys_and_device(mini_cfg, capsys):
    tool = _tool("serve_bench_torch")
    rc = tool.main(["--model_def", mini_cfg, "--device", "cpu", "--fast_path", "False",
                    "--concurrency", "2", "--duration", "1", "--batch_size", "2",
                    "--img_side", "128", "--ab", "True"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert rc == 0 and [r["mode"] for r in lines] == ["jpeg", "raw"]
    for r in lines:
        assert list(r) == _jax_out_keys() + ["device"]
        assert r["device"] == "cpu" and r["errors"] == 0 and r["n_ok"] > 0
        assert r["queue_depth_max"] <= r["max_queue"] and r["precision"] == "bf16"


# -- bench_trainstep ------------------------------------------------------

def _jax_step_line_pattern():
    """A regex of the line tools/bench_trainstep.py prints per step: its
    f-string's constant parts, each value a non-space run."""
    fn = _function("bench_trainstep.py", "bench_step")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "print"
                and isinstance(n.args[0], ast.JoinedStr)
                and "ms/step" in ast.unparse(n.args[0]))
    parts = [re.escape(v.value) if isinstance(v, ast.Constant) else r"(.*?)"
             for v in call.args[0].values]
    return re.compile("^" + "".join(parts) + "$")


def test_trainstep_line_and_json(mini_cfg, capsys):
    tool = _tool("bench_trainstep_torch")
    rec = tool.main(["--model_def", mini_cfg, "--device", "cpu", "--batch", "2", "--size",
                     "64", "--iters", "2", "--dtype", "f32"])
    out = capsys.readouterr().out.splitlines()
    m = _jax_step_line_pattern().match(out[-2])
    assert m, out[-2]
    b, size, dtype, tag, ms, ips = m.groups()
    assert (b, size, dtype + tag) == ("2", "64", "f32")
    assert (ms, ips) == (f"{rec['ms_per_step']:.2f}", f"{rec['img_per_s']:.1f}")
    assert json.loads(out[-1]) == rec
    assert list(rec) == ["batch", "size", "dtype", "tag", "ms_per_step", "img_per_s",
                         "host_enqueue_ms", "device"]
    assert rec["device"] == "cpu" and rec["ms_per_step"] > 0 and np.isfinite(rec["img_per_s"])
    # --warp-ab: the per-row shear and the bilinear warp, then the step as the reference
    rec = tool.main(["--warp-ab", "--model_def", mini_cfg, "--device", "cpu", "--batch", "2",
                     "--size", "32", "--iters", "1"])
    out = capsys.readouterr()
    warps = [l.split()[1] for l in out.out.splitlines() if l.startswith("  warp ")]
    assert warps == ["shear3_per_row", "bilinear"] and rec["size"] == 32
    assert "# card: cpu" in out.err and "shear3_grouped" in out.err


def test_trainstep_arms(mini_cfg, capsys):
    tool = _tool("bench_trainstep_torch")
    common = ["--model_def", mini_cfg, "--device", "cpu", "--batch", "2", "--size", "64",
              "--iters", "1"]
    forms = tool.main(common + ["--forms-ab"])
    assert list(forms) == ["reduce", "matmul"]
    assert [r["tag"] for r in tool.main(common + ["--s2d-ab"])] == ["stem=standard",
                                                                     "stem=s2d"]
    assert tool.bench_warp(2, 32, 1, "cpu") > 0
    assert tool.bench_warp(2, 32, 1, "cpu", warp="bilinear") > 0
    out = capsys.readouterr()
    assert "warp shear3" in out.out and "warp bilinear" in out.out
    assert "targets=dense arms are left out" in out.err


# -- bench_int8_block -----------------------------------------------------

def _jax_arms(d):
    """The reference tool's ``prod_block`` and ``ref_int32`` over the draws
    ``d``, with its pack and scale set-up."""
    sx, s1, s_out = 0.011, 0.017, 0.023
    c, c2 = d["w1q"].shape[2], d["w1q"].shape[3]
    w1p, a1p, b1p, w2p, a2p, b2p = jax_int8_block.pack_int8_block(
        d["w1q"], d["ws1"], d["b1"], d["w2q"], d["ws2"], d["b2"])
    ns = dict(jax=jax, jnp=jnp, reference_block_int8=jax_int8_block.reference_block_int8,
              _leaky=jax_int8_block._leaky, _requant=jax_int8_block._requant, C=c, C2=c2,
              w1p=w1p, a1p=a1p * sx, b1p=b1p, w2p=w2p, a2p=a2p * s1, b2p=b2p, sx=sx, s1=s1,
              s_out=s_out)
    for name in ("prod_block", "ref_int32"):
        exec(compile(ast.Module([_function("bench_int8_block.py", name)], []), name, "exec"),
             ns)
    return ns["prod_block"], ns["ref_int32"]


def test_int8_block_draws_are_the_jax_tools():
    """The tool's draws follow tools/bench_int8_block.py's statements in order."""
    tool = _tool("bench_int8_block_torch")
    fn = _function("bench_int8_block.py", "main")
    loop = next(n for n in ast.walk(fn) if isinstance(n, ast.For)
                and ast.unparse(n.target) == "spec")
    draws = [n for n in loop.body if isinstance(n, ast.Assign) and "rng." in ast.unparse(n)]
    ns = dict(np=np, jnp=jnp, rng=np.random.RandomState(0), B=2, H=8, C=64, C2=32)
    exec(compile(ast.Module(draws, []), "draws", "exec"), ns)
    got = tool.unit_draws(np.random.RandomState(0), 8, 64, 32, 2)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(ns[k]))


def test_int8_block_arms_equal_jax_tool_level_for_level():
    tool = _tool("bench_int8_block_torch")
    d = tool.unit_draws(np.random.RandomState(0), 8, 64, 32, 2)
    arms, _ = tool.make_arms(d, torch.device("cpu"))
    prod_block, ref_int32 = _jax_arms(d)
    x = torch.from_numpy(d["xq"])
    with torch.inference_mode():
        got = {k: fn(x).numpy() for k, fn in arms.items()}
    want_prod = np.asarray(jit_compiled(prod_block, jnp.asarray(d["xq"])))
    want_ref = np.asarray(jit_compiled(ref_int32, jnp.asarray(d["xq"])))
    want_eager = np.asarray(jax_int8_block.reference_block_int8(
        jnp.asarray(d["xq"]), *_pack_for_reference(d), sx=0.011, s1=0.017, s_out=0.023))
    np.testing.assert_array_equal(got["executor_int8 (bf16 sums)"], want_prod)
    np.testing.assert_array_equal(got["plain_int32"], want_ref)
    np.testing.assert_array_equal(got["plain_int32"], want_eager)
    np.testing.assert_array_equal(got["k3"], got["plain_int32"])
    assert (got["executor_int8 (bf16 sums)"] != got["plain_int32"]).any()  # bf16 sums differ


def _pack_for_reference(d):
    w1p, a1p, b1p, w2p, a2p, b2p = jax_int8_block.pack_int8_block(
        d["w1q"], d["ws1"], d["b1"], d["w2q"], d["ws2"], d["b2"])
    return w1p, a1p * 0.011, b1p, w2p, a2p * 0.017, b2p


def test_int8_block_run_on_cpu(capsys):
    tool = _tool("bench_int8_block_torch")
    rows = tool.run(["8,64,32,8"], batch=2, chain=1, iters=1, device="cpu")
    assert len(rows) == 1 and rows[0]["k3_mismatch"] == 0 and rows[0]["device"] == "cpu"
    assert set(rows[0]["ms"]) == {"executor_int8 (bf16 sums)", "plain_int32", "k3"}
    assert "k3_plan" not in rows[0]  # a plan exists only on the card
    assert "0 of 8192 levels differ" in capsys.readouterr().out
    assert tool.k3_bound(16, 13, 1024)[1] == "operations"
    assert tool.k3_bound(16, 208, 64)[1] == "bytes"


# -- bench_bn_stats -------------------------------------------------------

@pytest.mark.parametrize("batch,size", [(8, 416), (2, 320)])
def test_bn_shapes_equal_jax_tool(batch, size):
    tool, ref = _tool("bench_bn_stats_torch"), _tool("bench_bn_stats")
    got = tool.bn_shapes(graphspec.yolov3_spec(), batch, size)
    assert [(b, h, w, c) for b, c, h, w in got] == ref.bn_shapes(batch, size)
    assert len(got) == 72


def test_bn_stats_forms_run(mini_cfg, capsys):
    tool = _tool("bench_bn_stats_torch")
    out = tool.main(["--model_def", mini_cfg, "--batch", "2", "--size", "32", "--iters", "1",
                     "--device", "cpu"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert [r["form"] for r in lines] == ["reduce", "matmul"] == list(out)
    assert all(r["device_ms"] == "not measured" and r["device"] == "cpu" for r in lines)
    assert out["matmul"]["loss"] == pytest.approx(out["reduce"]["loss"], rel=1e-3)


# -- bench_s2d_down_b32 ---------------------------------------------------

def _jax_s2d_keys():
    """The keys of the JSON line tools/bench_s2d_down_b32.py prints per arm."""
    fn = _function("bench_s2d_down_b32.py", "main")
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Dict)
                and any(getattr(k, "value", None) == "s2d_downsample" for k in n.keys))
    return [k.value for k in node.keys]


def test_s2d_down_arms_keys_and_launches(capsys):
    """Both arms at full width on small tiles: the reference's keys first,
    then the launches per call (0 on the CPU) and the device."""
    tool = _tool("bench_s2d_down_b32_torch")
    assert tool.main(["--batch", "2", "--iters", "1", "--repeats", "1", "--side", "96",
                      "--size", "64", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    rows = [json.loads(l) for l in out.out.splitlines()]
    assert [r["s2d_downsample"] for r in rows] == [False, True]
    for r in rows:
        assert list(r) == _jax_s2d_keys() + ["launches_per_call", "device"]
        assert r["device"] == "cpu" and r["ms_per_batch"] > 0
        assert set(r["launches_per_call"].values()) == {0.0}
    assert "# card: cpu" in out.err
