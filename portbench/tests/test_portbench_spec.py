"""``BENCHMARK.json`` against the contract's shape, the files each name
finds, and the import rules: nothing under ``portbench/`` imports JAX or
the JAX package, and ``reference/`` imports nothing of the port."""
import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

from portbench import run, spec

from conftest import REPO

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
PB = os.path.join(REPO, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _reporting(metric):
    return set(metric.get("workloads", CELLS))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == want, e
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E[
        "setup_s"]
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(CELLS) // 4)


def test_every_cell_reports_what_the_contract_asks():
    for cell in CELLS:
        e2e = {n for n, m in E2E.items() if cell in _reporting(m)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        layer = [m for m in BENCH["per_layer"] if cell in _reporting(m)]
        assert layer, cell


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        moved = E2E[m["moves"]]
        assert _reporting(m) <= _reporting(moved), m["name"]


def test_layers_of_one_name_are_spelt_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    lowered = {x.lower() for x in layers}
    assert len(lowered) == len(layers)


def test_every_name_finds_its_file():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"], REPO)
        assert cell.limits and all("limit" in v
                                   for v in cell.limits.values())
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"], REPO))
    assert set(spec.kernel_families()) >= {"quantized_linear",
                                           "decode_attention"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources(PB):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "any4_tpu"), (path, name)


def test_reference_imports_nothing_of_the_port():
    # the reference and the harness modules it imports
    for path in list(_sources(os.path.join(PB, "reference"))) + list(
            _sources(os.path.join(PB, "formats"))) + [
            os.path.join(PB, "inputs.py")]:
        for name in _imports(path):
            assert name.split(".")[0] != "any4_tpu_torch", (path, name)
    code = ("import sys, portbench.reference.compare; print(sorted("
            "{m.split('.')[0] for m in sys.modules} & {'any4_tpu_torch', "
            "'any4_tpu', 'jax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.stdout.strip() == "[]", p.stderr


def _digests(top):
    return {os.path.relpath(p, top): hashlib.sha256(open(p, "rb").read())
            .hexdigest() for p in _sources(top)}


def test_a_new_cell_and_metric_need_only_new_files(tiny_root, tmp_path):
    """A cell on a new traffic mix and a per-layer metric with a new reader
    are files and entries added; no file there before changes."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "portbench"),
                    os.path.join(root, "portbench"))
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
    before = _digests(os.path.join(root, "portbench"))
    pb = os.path.join(root, "portbench")
    t = json.load(open(os.path.join(pb, "traffic", "chat16.json")))
    t.update(clients=2, what="two clients")
    t["engine"]["max_slots"] = 2
    json.dump(t, open(os.path.join(pb, "traffic", "chat2.json"), "w"))
    shutil.copy(os.path.join(pb, "limits", "mixtral8x7b.chat.json"),
                os.path.join(pb, "limits", "mistral7b.chat2.json"))
    with open(os.path.join(pb, "metrics", "steps_per_s.serve.py"), "w") as f:
        f.write("def read(run):\n    w = run.window[1] - run.window[0]\n"
                "    return len(run.steps) / w\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "mistral7b.chat2",
                               "config": "mistral7b", "traffic": "chat2",
                               "chips": 1, "why": "two clients"})
    for m in bench["end_to_end"]:
        if m["name"] in ("output_tok_s", "itl_p95_ms"):
            m["workloads"].append("mistral7b.chat2")
    bench["per_layer"].append({
        "name": "steps_per_s.serve", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "serving engine",
        "moves": "output_tok_s", "workloads": ["mistral7b.chat2"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    cell = spec.load_cell("mistral7b.chat2", root)
    r = run.run_cell(cell, 7, 1.5, True, "cpu", time.perf_counter())
    assert r["metrics"]["steps_per_s.serve"]["value"] > 0
    after = _digests(os.path.join(root, "portbench"))
    assert {k: after[k] for k in before} == before


def _open_loop_cell(root, name="mistral7b.open"):
    """A cell of open-loop arrivals added to the copy under ``root`` as a
    traffic file, a limits file and an entry."""
    pb = os.path.join(root, "portbench")
    t = json.load(open(os.path.join(pb, "traffic", "chat16.json")))
    t.update(what="open loop", queue=64,
             arrivals={"process": "poisson", "rate": 40.0, "group": 2})
    json.dump(t, open(os.path.join(pb, "traffic", "open.json"), "w"))
    shutil.copy(os.path.join(pb, "limits", "mistral7b.chat.json"),
                os.path.join(pb, "limits", name + ".json"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": name, "config": "mistral7b",
                               "traffic": "open", "chips": 1,
                               "why": "open loop"})
    for m in bench["end_to_end"]:
        if m["name"] in ("output_tok_s", "ttft_p95_ms"):
            m["workloads"].append(name)
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))


def test_open_loop_arrivals_are_data(tiny_root, tmp_path):
    """Open-loop arrivals in bursts are a traffic file; the run sends each
    request at its arrival and judges what it served."""
    from portbench import inputs
    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "portbench"),
                    os.path.join(root, "portbench"))
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
    before = _digests(os.path.join(root, "portbench"))
    _open_loop_cell(root)
    cell = spec.load_cell("mistral7b.open", root)
    arr = [inputs.open_arrivals(cell.traffic, 512, s) for s in (3, 2**33)]
    assert [t for t, _ in arr[0]] == sorted(t for t, _ in arr[0])
    assert arr[0][0][0] == arr[0][1][0]          # groups of two
    # every seed: the same gaps and sizes, in its own order
    for k in (lambda a: sorted(round(y - x, 9) for (x, _), (y, _)
                               in zip([(0.0, None)] + a[::2], a[::2])),
              lambda a: sorted((len(r.prompt), r.max_new_tokens)
                               for _, r in a)):
        assert k(arr[0]) == k(arr[1])
    r = run.run_cell(cell, 9, 1.5, False, "cpu", time.perf_counter())
    assert r["correct"] and r["attempted"] > 0, r
    assert set(r["metrics"]) == {"output_tok_s", "ttft_p95_ms", "setup_s"}
    after = _digests(os.path.join(root, "portbench"))
    assert {k: after[k] for k in before} == before


def test_a_new_format_is_new_files(tiny_root, tmp_path):
    """A quantization format is ``formats/<name>.py`` and ``pack/<name>.py``,
    found by the configuration's ``format``; an unknown one is refused by
    name."""
    from portbench import drivers, formats, pack
    import pytest
    for load in (formats.load, pack.load, drivers.load):
        with pytest.raises(ValueError, match="no "):
            load("nothing_here")
    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "portbench"),
                    os.path.join(root, "portbench"))
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
    before = _digests(os.path.join(root, "portbench"))
    pb = os.path.join(root, "portbench")
    for d in ("formats", "pack"):
        shutil.copy(os.path.join(pb, d, "any4.py"),
                    os.path.join(pb, d, "any4b.py"))
    c = json.load(open(os.path.join(pb, "configs", "mistral7b.json")))
    c["quantization"]["format"] = "any4b"
    json.dump(c, open(os.path.join(pb, "configs", "mistral7b_b.json"), "w"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append(dict(bench["configs"][1], name="mistral7b_b",
                                 file="portbench/configs/mistral7b_b.json"))
    bench["workloads"].append({"name": "mistral7b_b.ppl2k",
                               "config": "mistral7b_b", "traffic": "ppl2k",
                               "chips": 1, "why": "another format"})
    for m in bench["end_to_end"]:
        if m["name"] == "score_tok_s":
            m["workloads"].append("mistral7b_b.ppl2k")
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    shutil.copy(os.path.join(pb, "limits", "mistral7b.ppl2k.json"),
                os.path.join(pb, "limits", "mistral7b_b.ppl2k.json"))
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from portbench import run, spec, formats; "
            "c = spec.load_cell('mistral7b_b.ppl2k', '.'); "
            "r = run.run_cell(c, 4, 1.0, False, 'cpu', time.perf_counter()); "
            "print(r['correct'], formats.load('any4b').__file__)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]))
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.stdout.split() == [
        "True", os.path.join(root, "portbench", "formats", "any4b.py")], \
        p.stderr[-2000:]
    after = _digests(os.path.join(root, "portbench"))
    assert {k: after[k] for k in before} == before
