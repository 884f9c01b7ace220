"""The harness: its manifest against the benchmark's rules, finding every
part by name, the import check, the refusal to run without a card, whole
runs at a tiny size on the CPU (sound, and with each fault planted under
the timed path), and the control."""

import json
import os
import re
import shutil
import subprocess
import sys

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
    """In a fresh process: a whole tiny run of each kind loads nothing of
    JAX or the JAX package, and the reference nothing of the program."""
    r = _python(
        "import sys; sys.path.insert(0, '.');"
        "from benchmark.reference import xlsr_aasist;"
        "from benchmark.harness import compare, audio, weights;"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('rtdsd_tpu_torch', 'rtdsd_tpu', 'jax', 'flax')], 'ref';"
        "from benchmark.tests import tiny; from benchmark.harness import runner;"
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
    if not trace:
        assert got == {m["name"] for m in want}


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
