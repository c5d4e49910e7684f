"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file behind it.  CPU only, no run."""

import importlib
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes(bench):
    assert set(bench) == TOP
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    for kind, keys in KEYS.items():
        assert 1 <= len(bench[kind])
        for entry in bench[kind]:
            assert keys <= set(entry) <= keys | {"workloads"}, entry
            if kind in ("configs", "workloads"):
                assert "workloads" not in entry
    assert len(bench["configs"]) <= 24 and len(bench["workloads"]) <= 24
    assert len(bench["end_to_end"]) <= 16 and len(bench["per_layer"]) <= 128


def test_names_units_and_texts(bench):
    for kind in KEYS:
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
        for e in bench[kind]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _text_ok(e[key]), (e["name"], key)
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    words = bench["command"]
    assert 1 <= len(words) <= 32 and all(_text_ok(w) for w in words)
    for w in words:
        assert not w.startswith("/") and ".." not in w.split("/")


def test_paths_hold_the_benchmark(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert os.path.isdir(os.path.join(REPO, p))
    inside = lambda f: any(f == p or f.startswith(p.rstrip("/") + "/")
                           for p in bench["paths"])
    assert all(inside(c["file"]) for c in bench["configs"])
    assert any(inside(w) for w in bench["command"])


def test_bounds_and_run_seconds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in bench["end_to_end"]}["setup_s"] \
        <= 0.25
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits into its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _reports(bench, metric, cell):
    if "workloads" in metric:
        return cell in metric["workloads"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if metric["name"] in e2e:
        return True
    return _reports(bench, e2e[metric["moves"]], cell)


def test_per_layer_metrics_name_their_layer_and_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        for cell in m["workloads"]:
            assert _reports(bench, e2e[m["moves"]], cell), (m["name"], cell)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if _reports(bench, m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(bench, m, w["name"]) for m in bench["per_layer"])
        assert w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_every_name_has_its_files(bench):
    pb = os.path.join(REPO, "perfbench")
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"]
        for part in ("reference", "drivers"):
            assert os.path.isfile(os.path.join(pb, part,
                                               cfg["family"] + ".py"))
    for w in bench["workloads"]:
        with open(os.path.join(pb, "mixes", w["traffic"] + ".json")) as fh:
            mix = json.load(fh)
        assert {"entry", "pool", "check", "trace_calls", "warm"} <= set(mix)
        with open(os.path.join(pb, "cells", w["name"] + ".json")) as fh:
            cell = json.load(fh)
        assert cell["limits"] and "control" in cell
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = importlib.import_module(f"perfbench.metrics.{m['name']}")
        assert callable(mod.read)


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.qtt_poisson, "
            "perfbench.reference.tt_round; "
            "from perfbench.harness import forbidden_modules, "
            "FORBIDDEN_IN_REFERENCE; "
            "print(forbidden_modules(FORBIDDEN_IN_REFERENCE))" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
