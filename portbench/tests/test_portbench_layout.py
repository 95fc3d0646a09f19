"""BENCHMARK.json and the files it names: every cell, configuration and metric
resolves to its files, the names keep the contract's alphabet, the result
line has the contract's keys, and nothing the benchmark loads is JAX or the
JAX package."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import core

BENCH = core.BENCH_DIR
SPEC = json.loads((core.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"} and entry["chips"] == 1
    cell = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    assert cell["name"] == name and cell["config"] == entry["config"]
    assert (BENCH / "drivers" / f"{cell['driver']}.py").is_file()
    for key in ("setup", "window", "profile", "release", "check"):
        assert callable(getattr(core.load_file(BENCH / "drivers" / f"{cell['driver']}.py",
                                               f"t_{cell['driver']}"), key))
    reports = [m["name"] for m in SPEC["end_to_end"] if name in m.get("workloads", [name])]
    assert "setup_s" in reports and len(reports) >= 2
    assert any(name in m.get("workloads", [name]) for m in SPEC["per_layer"])
    assert set(cell["check"]["limits"]) and all(v > 0 for v in cell["check"]["limits"].values())


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = json.loads((core.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cfg and key in cfg["assumed"]
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_keys(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert metric["workloads"] and set(metric["workloads"]) <= set(CELLS)
        reader = core.load_file(BENCH / "metrics" / f"{metric['name']}.py", f"t_{metric['name']}")
        assert callable(reader.read)
        if metric["unit"] == "%" and "roofline" in metric["name"]:
            assert metric["name"].endswith("_roofline")


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


def test_forbidden_compares_whole_names():
    assert core.forbidden_modules(["diffpose_tpu_torch.ops.fused_train", "numpy", "jaxtyping"]) == []
    assert core.forbidden_modules(["jaxlib.xla_client", "diffpose_tpu.models", "flax"]) == [
        "diffpose_tpu", "flax", "jaxlib"]


def test_nothing_loads_jax():
    """Import every module the harness runs, in a fresh process, and drive a
    tiny frame-eval cell on the CPU: no jax, jaxlib, flax or diffpose_tpu."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests.tiny import tiny_run\n"
        "from portbench.harness import core\n"
        "import glob, os\n"
        "for f in glob.glob(os.path.join(%r, '*', '*.py')):\n"
        "    if '/tests/' not in f: core.load_file(core.Path(f), 'm_' + os.path.basename(f))\n"
        "tiny_run('frame-eval-h5')\n"
        "print(core.forbidden_modules())\n") % (str(core.ROOT), str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=core.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"diffpose_tpu_torch", "diffpose_tpu", "jax", "jaxlib", "flax"}, f
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.frame, portbench.reference.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'diffpose_tpu_torch', 'diffpose_tpu', 'jax', 'jaxlib', 'flax'}))\n") % str(core.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_refuses_without_card():
    """No card: exit code other than 0 and no result line."""
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "frame-eval-h5",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=core.ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(core.ROOT / "build")})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_result_line_keys(trace):
    from portbench.tests.tiny import tiny_run

    res = tiny_run("frame-eval-h5", trace=trace)
    assert list(res)[-1] == "checks"
    required = {"correct", "attempted", "failed", "metrics", "device"}
    assert required <= set(res) <= required | {"breakdown", "checks"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    names = {m["name"] for m in SPEC["end_to_end"] if "frame-eval-h5" in m.get("workloads", ["frame-eval-h5"])}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["metrics"]) <= {m["name"] for m in SPEC["per_layer"]}
    else:
        assert set(res["metrics"]) == names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert res["correct"] is True
