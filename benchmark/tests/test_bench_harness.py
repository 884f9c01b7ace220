"""The harness: its manifest against the benchmark's rules, finding every
part by name, a model family's parts kept out of the shared code, the
import check, the refusal to run without a card, whole runs at a tiny size
on the CPU (sound, and with each fault planted under the timed path), the
control, and a second family's cells added as files."""

import ast
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tokenize

import pytest

from benchmark.harness import runner
from benchmark.tests import tiny

ROOT = runner.ROOT
MAN = runner.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_names_and_units():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line_ok(c["source"])
        assert _line_ok(c["why"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line_ok(w["why"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in MAN["end_to_end"] else {"layer",
                                                              "moves"}
        assert set(m) <= allowed and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(MAN)) < 64 * 1024


def test_every_part_is_found_by_name():
    for c in MAN["configs"]:
        assert runner.config(c["name"])["name"] == c["name"]
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    for w in MAN["workloads"]:
        wl = runner.workload(w["name"])
        assert {k: wl[k] for k in ("name", "config", "traffic", "chips")} == \
            {k: w[k] for k in ("name", "config", "traffic", "chips")}
        assert hasattr(runner.traffic(wl["kind"]), "run")
        assert set(wl["limits"]) == {"gap_q50", "gap_max",
                                     "low_precision_ops"}
        assert wl["limits"]["low_precision_ops"] == 0
    for m in MAN["per_layer"]:
        assert callable(runner.reader(m["name"]).read)
        assert runner.reader(m["name"]).read({}) is None


FAMILY_PACKAGES = tuple("benchmark." + part for part in runner.FAMILY_PARTS)
FAMILY_WORDS = re.compile(r"xlsr_aasist|xlsr_conformer|AASIST|Conformer|"
                          r"ssl_model|w2v")


@pytest.mark.parametrize("folder", ["harness", "traffic"])
def test_shared_code_names_no_family(folder):
    """The code every cell shares reaches a family's reference, counts and
    program adapter only through ``runner.family``: it imports none of
    them by name, and names no family's classes or attributes."""
    paths = sorted(p for p in os.listdir(os.path.join(runner.BENCH, folder))
                   if p.endswith(".py"))
    assert paths
    for name in paths:
        with open(os.path.join(runner.BENCH, folder, name)) as f:
            assert not _family_names(f.read()), name


def _family_names(src: str) -> list:
    """The imports of a family's modules and the family words in a
    module's code, less its comments and docstrings."""
    tree = ast.parse(src)
    docs = {(n.body[0].lineno, n.body[0].col_offset) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)
            and isinstance(n.body[0].value.value, str)}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            found.append(node.module or "")
    found = [m for m in found if m.startswith(FAMILY_PACKAGES)]
    return found + [t.string for t in tokenize.generate_tokens(
        io.StringIO(src).readline)
        if t.type != tokenize.COMMENT
        and not (t.type == tokenize.STRING and t.start in docs)
        and FAMILY_WORDS.search(t.string)]


@pytest.mark.parametrize("src,found", [
    ("from benchmark.reference import xlsr_aasist as ref\n", True),
    ("import benchmark.counts.xlsr_conformer\n", True),
    ("from benchmark.programs.xlsr_aasist import stages\n", True),
    ("def f(m):\n    return m.ssl_model.model\n", True),
    ("x = 'AASISTBackend'\n", True),
    ('"""Reads AASIST\'s w2v keys."""\n# ssl_model\nx = 1\n', False),
    ("from benchmark.harness import runner\n", False),
])
def test_the_static_check_sees_a_family_name(src, found):
    """The check above fails a module that imports a family's parts or
    names a family's classes in code, and passes one that names them only
    in a comment or a docstring."""
    assert bool(_family_names(src)) == found


def test_each_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in runner.cell_metrics(MAN, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert runner.cell_metrics(MAN, w["name"], True)


def test_a_per_layer_metrics_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and _line_ok(m["layer"])
        for cell in m.get("workloads", [w["name"] for w in MAN["workloads"]]):
            assert runner.reports(e2e[m["moves"]], cell, MAN), (m, cell)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("loaded,bad", [
    (["rtdsd_tpu_torch", "rtdsd_tpu_torch.ops.gat", "numpy"], []),
    (["rtdsd_tpu.models.zoo"], ["rtdsd_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen", "optax"],
     ["flax", "jax", "jaxlib", "optax"]),
    (["jaxtyping", "flaxen", "rtdsd_tpu_tools"], []),
])
def test_forbidden_modules_compares_whole_top_level_names(monkeypatch,
                                                          loaded, bad):
    fake = {name: object() for name in loaded}
    monkeypatch.setattr(sys, "modules", fake)
    assert runner.forbidden_modules() == bad


def _python(code: str, cwd: str = ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_tiny_run_and_the_reference_load_no_jax():
    """In a fresh process: both families' references, and a reference run
    of each, load nothing of the program, JAX or the JAX package, and a
    whole tiny run of each kind nothing of JAX or the JAX package."""
    r = _python(
        "import sys, torch; sys.path.insert(0, '.');"
        "from benchmark.reference import xlsr_aasist, xlsr_conformer;"
        "from benchmark.harness import compare, audio, weights;"
        "from benchmark.tests import tiny;"
        "from benchmark.harness import runner;"
        "cpu = torch.device('cpu');"
        "[m.bonafide_scores(weights.model_weights(c, 1, cpu), m.ModelShape(c),"
        " torch.zeros(2, 16000)) for m, c in ("
        "(xlsr_aasist, tiny.config('xlsr_aasist')),"
        " (xlsr_conformer, tiny.config('tiny_conformer')))];"
        "assert not runner.forbidden_modules();"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('rtdsd_tpu_torch', 'rtdsd_tpu', 'jax', 'flax')], 'ref';"
        "[tiny.run(tiny.context(c)) for c in "
        "('aasist_score_b40', 'aasist_serve_paced')];"
        "print(runner.forbidden_modules())")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_exits_nonzero_without_a_result():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "aasist_score_b40", "--seed", str(2 ** 31 + 3),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_only_the_benchmark_files_exit_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "aasist_score_b40", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_new_parts_are_added_as_files_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic kind, a
    cell and a per-layer metric as new files and one manifest entry each;
    the harness finds and runs them with no other file edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MAN))
    bench = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = tiny.config("xlsr6_aasist", layers=1)
    cfg["name"] = "tiny_student"
    (bench / "configs" / "tiny_student.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / "student_serve_paced.json")
                    .read_text())
    wl.update(name="tiny_serve", config="tiny_student", traffic="tiny_mix",
              kind="serve_again")
    (bench / "traffic" / "serve_again.py").write_text(
        "from benchmark.traffic.serve_paced import fp8_gaps, run  # noqa\n")
    wl["params"].update(tiny.PARAMS["serve_paced"])
    (bench / "workloads" / "tiny_serve.json").write_text(json.dumps(wl))
    (bench / "metrics" / "late_ms_max.serve.py").write_text(
        "def read(r):\n    return r.get('late_ms_max')\n")
    man["configs"].append({"name": "tiny_student", "source": "test",
                           "file": "benchmark/configs/tiny_student.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "tiny_serve", "config": "tiny_student",
                             "traffic": "tiny_mix", "chips": 1,
                             "why": "test"})
    man["end_to_end"][1]["workloads"].append("tiny_serve")
    man["per_layer"].append({"name": "late_ms_max.serve", "unit": "ms",
                             "better": "lower", "source": "host_clock",
                             "layer": "serving engine",
                             "moves": "window_p95_ms",
                             "workloads": ["tiny_serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = (
        "import sys, time, torch; sys.path.insert(0, '.');"
        f"sys.path.append({ROOT!r});"
        "from benchmark.harness import runner;"
        "assert runner.ROOT == '.' or runner.ROOT.endswith("
        f"{str(tmp_path.name)!r});"
        "man = runner.manifest(); wl = runner.workload('tiny_serve');"
        "ctx = runner.Context('tiny_serve', wl, runner.config(wl['config']),"
        " 5, 1.0, True, torch.device('cpu'), t_start=time.perf_counter());"
        "out = runner.traffic(wl['kind']).run(ctx);"
        "line = runner.result_line(man, 'tiny_serve', ctx, out, {});"
        "print(sorted(line['metrics']), line['correct'])")
    r = _python(code, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "'late_ms_max.serve'" in r.stdout and "True" in r.stdout
    after = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in str(p)}
    assert all(after[p] == b for p, b in before.items())


def _off_the_card(metrics) -> set:
    """The end-to-end metrics a run without a card reports: all but those
    read from the device trace."""
    return {m["name"] for m in metrics if m["source"] != "device_trace"}


# Run in a copy of the benchmark that holds a second family's cells: each
# sound run's result line, and each fault's and the fp8 control's numbers
# beside the cell's limits.
DRIVE_NEW_FAMILY = """
import json, sys, time, torch
sys.path.insert(0, '.')
from benchmark.harness import runner
torch.set_num_threads(1)
man = runner.manifest()
out = {}
for cell in ('conformer_score', 'conformer_serve'):
    wl = runner.workload(cell)
    traffic = runner.traffic(wl['kind'])
    def ctx(trace=False, fault=None):
        return runner.Context(cell, wl, runner.config(wl['config']),
                              2 ** 31 + 7, 1.0, trace, torch.device('cpu'),
                              fault=fault, t_start=time.perf_counter())
    for trace in (False, True):
        c = ctx(trace)
        out[f'{cell} trace {int(trace)}'] = runner.result_line(
            man, cell, c, traffic.run(c), {})
    for fault in ('half_batch', 'altered'):
        c = ctx(fault=fault)
        out[f'{cell} {fault}'] = runner.result_line(
            man, cell, c, traffic.run(c), {})['checks']
    gaps = traffic.fp8_gaps(ctx())
    out[f'{cell} fp8'] = {k: {'value': v, 'limit': wl['limits'][k]}
                          for k, v in gaps.items()}
print(json.dumps(out))
"""


def test_a_new_family_enters_as_new_files(tmp_path):
    """A copy of the benchmark gains a tiny configuration of the
    ``xlsr_conformer`` family, and a cell of each traffic kind on it, as
    new files and manifest entries. Each cell runs correct with and
    without the trace, reports the metrics the manifest gives it, and is
    not correct with each planted fault or with the reference in fp8 in
    the program's place; no file that was there changes."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    man = json.loads(json.dumps(MAN))
    (bench / "configs" / "tiny_conformer.json").write_text(
        json.dumps(tiny.config("tiny_conformer")))
    man["configs"].append({"name": "tiny_conformer", "source": "test",
                           "file": "benchmark/configs/tiny_conformer.json",
                           "reduced": [], "why": "test"})
    new = {"conformer_score": "aasist_score_b40",
           "conformer_serve": "aasist_serve_paced"}
    for cell, like in new.items():
        wl = runner.workload(like)
        wl.update(name=cell, config="tiny_conformer", traffic=cell + "_mix",
                  limits=tiny.LIMITS)
        wl["params"].update(tiny.PARAMS[wl["kind"]])
        (bench / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
        man["workloads"].append({"name": cell, "config": "tiny_conformer",
                                 "traffic": cell + "_mix", "chips": 1,
                                 "why": "test"})
        for m in man["end_to_end"] + man["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    r = _python(f"import sys; sys.path.append({ROOT!r})\n"
                + DRIVE_NEW_FAMILY, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    for cell in new:
        for trace in (0, 1):
            line = got[f"{cell} trace {trace}"]
            assert line["correct"] and line["failed"] == 0, line["checks"]
            assert line["checks"]["low_precision_ops"]["value"] == 0
            assert list(line)[-1] == "checks"
            metrics = runner.cell_metrics(man, cell, bool(trace))
            want = {m["name"] for m in metrics}
            assert want and set(line["metrics"]) <= want
            if not trace:           # a CPU run reads no device trace
                assert set(line["metrics"]) == _off_the_card(metrics)
        for control in ("half_batch", "altered", "fp8"):
            checks = got[f"{cell} {control}"]
            assert any(c["value"] > c["limit"] for c in checks.values()), \
                (cell, control, checks)
    after = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in str(p)}
    assert all(after[p] == b for p, b in before.items())


@pytest.mark.parametrize("cell", ["aasist_score_b40", "aasist_serve_paced"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_tiny_run_is_correct(cell, trace):
    line = tiny.run(tiny.context(cell, trace=trace))
    assert line["correct"] and line["failed"] == 0
    assert line["checks"]["low_precision_ops"]["value"] == 0
    assert list(line)[-1] == "checks"
    want = runner.cell_metrics(MAN, cell, trace)
    got = set(line["metrics"])
    assert got <= {m["name"] for m in want}
    if not trace:               # a CPU run reads no device trace
        assert got == _off_the_card(want)


def test_the_scoring_cells_card_time_is_the_traced_calls_busy_time(
        monkeypatch):
    """``card_ms_per_clip`` is the busy time of the device operations in
    the call traced after the window, over the clips that call scored."""
    from benchmark.harness import trace

    def traced(fn):
        out = fn()
        # two overlapping operations and one apart: 3 ms busy in 10 ms
        ops = [("k", 0, 2_000_000), ("k", 1_000_000, 2_000_000),
               ("k", 5_000_000, 6_000_000)]
        return out, trace.Trace(ops, [("bench.section", 0, 10_000_000)],
                                0, 10_000_000)

    monkeypatch.setattr(trace, "traced", traced)
    line = tiny.run(tiny.context("aasist_score_b40"))
    assert line["correct"]
    clips = tiny.PARAMS["score_files"]["trace_files"]
    assert line["metrics"]["card_ms_per_clip"]["value"] == \
        pytest.approx(3.0 / clips)


@pytest.mark.parametrize("cell", ["aasist_score_b40", "aasist_serve_paced"])
@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    """Half of each dispatch's rows left out (the mean of the rest in
    their place), and one answer altered where it is produced."""
    line = tiny.run(tiny.context(cell, fault=fault))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["aasist_score_b40", "aasist_serve_paced",
                                  "student_serve_paced"])
def test_the_fp8_control_is_not_correct(cell):
    """The reference in fp8 in the program's place fails the cell's gap
    limits at a tiny size (2 layers of width 64)."""
    ctx = tiny.context(cell, layers=2, width=64)
    gaps = runner.traffic(ctx.workload["kind"]).fp8_gaps(ctx)
    assert any(v > ctx.workload["limits"][k] for k, v in gaps.items()), gaps


@pytest.mark.parametrize("cell", ["aasist_score_b40", "aasist_serve_paced"])
def test_the_programs_int8_path_is_not_correct(cell):
    """The program with its own int8 path (w8a8) on, in the timed path:
    the census counts its int8 matmuls."""
    ctx = tiny.context(cell)
    ctx.w8a8 = True
    line = tiny.run(ctx)
    assert not line["correct"]
    assert line["checks"]["low_precision_ops"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_the_controls_fail_at_the_cells_size_on_the_card(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the controls at the cell's own size")
    r = subprocess.run([sys.executable, "benchmark/control.py", "--workload",
                        cell, "--control-seeds", "11", "12", "13", "--runs",
                        "w8a8", "fp8"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("not correct on every seed") == 2, r.stdout
