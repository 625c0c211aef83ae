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
            _sources(os.path.join(PB, "formats"))) + list(
            _sources(os.path.join(PB, "archs"))) + [
            os.path.join(PB, "inputs.py")]:
        for name in _imports(path):
            assert name.split(".")[0] != "any4_tpu_torch", (path, name)
    code = ("import sys, portbench.reference.compare, portbench.archs.llama, "
            "portbench.archs.mistral, portbench.archs.mixtral; print(sorted("
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
    base = next(c for c in bench["configs"] if c["name"] == "mistral7b")
    bench["configs"].append(dict(base, name="mistral7b_b",
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
    r = _run_in_copy(root, "mistral7b_b.ppl2k", 4, "formats", "any4b")
    assert r["file"] == os.path.join(root, "portbench", "formats",
                                     "any4b.py")
    assert r["attempted"] == 4 and r["numbers"] == r["base"]
    assert r["correct"], r["checks"]
    after = _digests(os.path.join(root, "portbench"))
    assert {k: after[k] for k in before} == before


def test_an_unknown_model_type_is_refused_by_name():
    import pytest
    from portbench import archs, build, inputs, program
    for load in (archs.load, build.load):
        with pytest.raises(ValueError, match="no "):
            load("nothing_here")
    cfg = {"model_type": "nothing_here", "hidden_size": 8,
           "num_hidden_layers": 1, "quantization": {"group_size": 8}}
    for call in (lambda: program.model_config(cfg),
                 lambda: inputs.layer_linears(cfg, 0)):
        with pytest.raises(ValueError, match="no model_type 'nothing_here'"):
            call()


def test_a_new_architecture_is_new_files(tiny_root, tmp_path):
    """An architecture is ``archs/<model_type>.py`` and
    ``build/<model_type>.py``, found by the configuration's
    ``model_type``: the llama pair copied under another name, with a
    configuration, a cell and its limits, runs, comes out correct and
    reads what the cell it was copied from reads."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "portbench"),
                    os.path.join(root, "portbench"))
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
    before = _digests(os.path.join(root, "portbench"))
    pb = os.path.join(root, "portbench")
    for d in ("archs", "build"):
        shutil.copy(os.path.join(pb, d, "llama.py"),
                    os.path.join(pb, d, "llama_b.py"))
    c = json.load(open(os.path.join(pb, "configs", "mistral7b.json")))
    c["model_type"] = "llama_b"
    json.dump(c, open(os.path.join(pb, "configs", "mistral7b_c.json"), "w"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    base = next(c for c in bench["configs"] if c["name"] == "mistral7b")
    bench["configs"].append(dict(base, name="mistral7b_c",
                                 file="portbench/configs/mistral7b_c.json"))
    bench["workloads"].append({"name": "mistral7b_c.ppl2k",
                               "config": "mistral7b_c", "traffic": "ppl2k",
                               "chips": 1, "why": "another architecture"})
    for m in bench["end_to_end"]:
        if m["name"] == "score_tok_s":
            m["workloads"].append("mistral7b_c.ppl2k")
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    shutil.copy(os.path.join(pb, "limits", "mistral7b.ppl2k.json"),
                os.path.join(pb, "limits", "mistral7b_c.ppl2k.json"))
    r = _run_in_copy(root, "mistral7b_c.ppl2k", 3, "archs", "llama_b")
    assert r["file"] == os.path.join(root, "portbench", "archs",
                                     "llama_b.py")
    assert r["attempted"] == 4 and r["numbers"] == r["base"]
    assert r["correct"], r["checks"]
    after = _digests(os.path.join(root, "portbench"))
    assert {k: after[k] for k in before} == before


def _pattern_arch():
    """A toy architecture whose layer 0 is a Llama layer and whose later
    layers are Mixtral's, as a module of ``archs``."""
    import types
    from portbench.archs import llama, mixtral
    mod = types.ModuleType("portbench.archs.pattern_toy")

    def by_layer(fn):
        return lambda config, layer, *a: getattr(
            llama if layer == 0 else mixtral, fn)(config, layer, *a)
    for fn in ("linears", "experts", "draw_dense", "extra_flops",
               "attention_flops"):
        setattr(mod, fn, by_layer(fn))
    mod.check = llama.check
    mod.layer = lambda ref, x, w, layer: (
        llama if layer == 0 else mixtral).layer(ref, x, w, layer)
    return mod


def test_a_layer_pattern_draws_and_counts_each_layer(monkeypatch):
    """An architecture whose linears differ by layer (a dense layer, then
    routed ones): each layer is drawn with its own linears and leaves, the
    arithmetic counts each layer as it is, and the reference routes only
    where a layer does."""
    import math
    import sys
    import torch
    from portbench import inputs
    from portbench.archs import mixtral
    from portbench.metrics import _arith
    from portbench.record import Step
    from portbench.reference.model import Reference
    monkeypatch.setitem(sys.modules, "portbench.archs.pattern_toy",
                        _pattern_arch())
    moe = json.load(open(os.path.join(PB, "configs", "mixtral8x7b.json")))
    moe["num_hidden_layers"] = 4
    toy = dict(moe, model_type="pattern_toy")
    dense = dict(moe, model_type="llama")
    names = [[n for n, _, _ in inputs.layer_linears(toy, li)]
             for li in range(4)]
    assert names[0][4:] == ["gate_proj", "up_proj", "down_proj"]
    assert names[1] == names[3] and len(names[1]) == 4 + 3 * 8
    for m in (1, 16, 512):
        per = [_arith.layer_linear_seconds(toy, li, m) for li in range(4)]
        assert per[0] == _arith.layer_linear_seconds(dense, 0, m)
        assert per[1:] == [_arith.layer_linear_seconds(moe, 0, m)] * 3
        step = Step(0, 1, "decode", decode_ctx=[100] * m)
        assert math.isclose(_arith.step_linear_seconds(toy, step),
                            per[0] + 3 * per[1], rel_tol=1e-12)
    head = 2.0 * 4096 * 32000
    layer_flops = [(_arith.token_flops(c) - head) / 4 for c in (dense, moe)]
    assert math.isclose(_arith.token_flops(toy),
                        layer_flops[0] + 3 * layer_flops[1] + head,
                        rel_tol=1e-12)
    tiny = dict(toy, **mixtral.tiny(toy, f32=True))
    for li in range(2):
        fields, leaves = inputs.draw_layer(tiny, 5, li, "cpu")
        assert list(fields) == [n for n, _, _ in
                                inputs.layer_linears(tiny, li)]
        assert list(leaves) == ([] if li == 0 else ["router"])
    ref = Reference(tiny, 5, "cpu")
    ref.hidden([torch.arange(20)])
    (margin,) = ref.min_margin
    assert margin.shape == (20,) and bool(torch.isfinite(margin).all())


def _run_in_copy(root, cell, seed, package, module, windows=4):
    """One run of ``cell`` of the copy under ``root``, in an interpreter
    that finds the copy's modules first, scoring exactly ``windows``
    windows: the window's clock is a counter that moves half a second a
    reading, so the count does not hang on how fast the machine runs.
    Returns the result with the file of ``<package>/<module>.py`` as the
    run loaded it, and ``"base"``: the numbers of the cell the copy was
    made from (``cell`` up to its first ``_``) on the same seed and count."""
    code = f"""
import itertools, json, sys, time, types
sys.path.insert(0, ".")
from portbench import drive, run, spec
from portbench.{package} import load

def once(name):
    tick = itertools.count()
    drive.time = types.SimpleNamespace(perf_counter=lambda: next(tick) * 0.5)
    c = spec.load_cell(name, ".")
    return run.run_cell(c, {seed}, {float(windows)}, False, "cpu",
                        time.perf_counter(), control=True)

r = once({cell!r})
r["file"] = load({module!r}).__file__
r["base"] = once({cell.split("_")[0] + "." + cell.split(".", 1)[1]!r})["numbers"]
print(json.dumps(r))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]))
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])
