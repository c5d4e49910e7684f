"""The harness on the CPU at tiny sizes: new files are found by name, the
generators repeat by seed and agree with the port's examples, a run
without a card prints nothing, a tiny run loads no JAX, the faults a cell
can have make ``correct`` false; on the card, each cell's control does."""

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import qtt_poisson as rp
from perfbench.reference import tt_round as rr
from perfbench.tests.tiny import REPO, tiny_root

CPU = torch.device("cpu")
with open(os.path.join(REPO, "BENCHMARK.json")) as _fh:
    CELLS = [w["name"] for w in json.load(_fh)["workloads"]]
ROUND_CELLS = [c for c in CELLS
               if harness.load_cell(REPO, c)[2]["family"] == "tt_round"]
# each cell's control, and each fault its cell file plants, by name
CONTROLS = [(c, name) for c in CELLS for name in
            ["control"] + sorted(harness.load_cell(REPO, c)[4]
                                 .get("faults", {}))]


def _subprocess_run(root, code, timeout=600):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=timeout, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_quantile():
    assert harness.quantile([3.0], 0.9) == 3.0
    assert harness.quantile([float(i) for i in range(11)], 0.9) == 9.0
    assert harness.quantile([0.0, 10.0], 0.9) == 9.0


def test_counting_syncs_counts_only_the_sync_warnings():
    import warnings
    with harness.counting_syncs(CPU) as seen:
        warnings.warn(harness.SYNC_WARNING)
        warnings.warn("Synchronization debug mode is a prototype feature")
        warnings.warn(harness.SYNC_WARNING)
    assert seen == [2]


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    pb = os.path.join(root, "perfbench")
    before = {}
    for dirpath, _, names in os.walk(pb):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as fh:
                before[p] = fh.read()
    # a configuration, a mix, a cell and a metric, as new files only
    with open(os.path.join(pb, "configs", "qtt_poisson_d32_r30.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="poisson_throwaway", d=6, rank=3)
    with open(os.path.join(pb, "configs", "poisson_throwaway.json"),
              "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(pb, "mixes", "f32_solve.json")) as fh:
        mix = json.load(fh)
    mix["args"]["max_f32_sweeps"] = 2
    with open(os.path.join(pb, "mixes", "throwaway.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(pb, "cells", "poisson_throwaway.throwaway.json"),
              "w") as fh:
        json.dump({"limits": {"residual": 1.0}, "control": {}}, fh)
    with open(os.path.join(pb, "metrics", "calls_seen.py"), "w") as fh:
        fh.write("def read(run):\n    return float(run.calls)\n")
    # ... and entries in BENCHMARK.json
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "poisson_throwaway", "source": "x",
                             "file": "perfbench/configs/poisson_throwaway"
                                     ".json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "poisson_throwaway.throwaway",
                               "config": "poisson_throwaway",
                               "traffic": "throwaway", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "call_ms",
                               "workloads": ["poisson_throwaway.throwaway"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    # the copy's perfbench first, then the port
    code = ("import sys, json, time, torch; sys.path[:0] = [%r, %r]; "
            "from perfbench.harness import run_cell; "
            "out = run_cell(%r, 'poisson_throwaway.throwaway', 5, 0.3, True, "
            "torch.device('cpu'), time.perf_counter()); "
            "out.pop('breakdown'); print(json.dumps(out))"
            % (root, REPO, root))
    out = json.loads(_subprocess_run(root, code).strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["calls_seen"]["value"] == out["attempted"] >= 1
    for p, data in before.items():
        with open(p, "rb") as fh:
            assert fh.read() == data, p


def test_poisson_inputs_repeat_by_seed_and_agree_with_examples():
    from xerus_tpu_torch.examples import (host_poisson_residual,
                                          qtt_poisson_instance)
    cfg = {"d": 8, "n": 2, "rank": 4, "operator": "qtt_laplace",
           "rhs": "ones"}
    a = rp.make_inputs(cfg, 2 ** 31 + 11, 3, CPU)
    b = rp.make_inputs(cfg, 2 ** 31 + 11, 3, CPU)
    c = rp.make_inputs(cfg, 2 ** 31 + 12, 3, CPU)
    for x, y in zip(a["x0"], b["x0"]):
        assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert not torch.equal(a["x0"][0][0], c["x0"][0][0])
    xs, A, B = qtt_poisson_instance(8, 4, 7)
    assert all(np.array_equal(p, q) for p, q in zip(a["A"], A))
    assert all(np.array_equal(p, q) for p, q in zip(a["b"], B))
    for start in a["x0"]:
        assert [tuple(t.shape) for t in start] == [x.shape for x in xs]
        for core in start[1:]:           # right-canonical, core at site 0
            m = core.reshape(core.shape[0], -1)
            assert torch.allclose(m @ m.T, torch.eye(m.shape[0],
                                                     dtype=m.dtype),
                                  atol=1e-12)
    host = [t.numpy() for t in a["x0"][1]]
    assert rp.residual(host, A, B) == pytest.approx(
        host_poisson_residual(host, A, B), rel=1e-12)


def test_round_inputs_repeat_by_seed_and_the_reference_agrees_with_examples():
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          cpu_round_sweep, host_tt_distance,
                                          host_tt_log_norm)
    cfg = {"d": 10, "n": 2, "rank": 16, "target_rank": 8,
           "dtype": "float32"}
    a = rr.make_inputs(cfg, 2 ** 31 + 5, 2, CPU)["X"]
    b = rr.make_inputs(cfg, 2 ** 31 + 5, 2, CPU)["X"]
    assert all(torch.equal(p, q) for p, q in zip(a[1], b[1]))
    host = bench_round_instance(10, 2, 16, 3)
    assert [tuple(t.shape) for t in a[0]] == [c.shape for c in host]
    assert all(t.dtype == torch.float32 for t in a[0])
    x = [torch.from_numpy(c).double() for c in host]
    chain = rr.rounding_chain(x, 8)
    ref = cpu_round_sweep(host, 8)
    assert rr.tt_log_norm(chain) == pytest.approx(host_tt_log_norm(ref),
                                                  rel=1e-12)
    assert rr.tt_distance(chain, [torch.from_numpy(c) for c in ref]) <= \
        1e-10 * math.exp(host_tt_log_norm(ref))
    assert rr.tt_distance(x, chain) == pytest.approx(
        host_tt_distance(host, ref), rel=1e-9)
    # X projected onto its own left frames is X; a projection is idempotent
    norm = math.exp(rr.tt_log_norm(x))
    assert rr.tt_distance(x, rr.left_projection(x, x)) <= 1e-12 * norm
    px = rr.left_projection(x, chain)
    assert rr.tt_distance(px, rr.left_projection(px, chain)) <= 1e-12 * norm
    assert rr.rank_over(cfg, chain) == 0.0


def test_run_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          CELLS[0], "--seed", "4000000001", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_without_the_port_exits_nonzero(tmp_path):
    root = os.path.join(str(tmp_path), "bare")
    shutil.copytree(os.path.join(REPO, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    code = ("import sys, time, torch; sys.path.insert(0, %r); "
            "from perfbench.harness import run_cell; "
            "run_cell(%r, %r, 5, 0.3, False, torch.device('cpu'), "
            "time.perf_counter())" % (root, root, CELLS[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "xerus_tpu_torch" in out.stderr


def test_tiny_cpu_runs_load_no_jax(tmp_path):
    root = tiny_root(tmp_path)
    code = ("import sys, json, time, torch; sys.path.insert(0, %r); "
            "from perfbench.harness import run_cell, forbidden_modules; "
            "outs = [run_cell(%r, c, 9, 0.3, False, torch.device('cpu'), "
            "time.perf_counter())['correct'] for c in %r]; "
            "print(json.dumps([outs, forbidden_modules()]))"
            % (REPO, root, CELLS))
    outs, bad = json.loads(_subprocess_run(root, code).strip()
                           .splitlines()[-1])
    assert outs == [True] * len(CELLS)
    assert bad == []


def _alter(system, result):
    """Scale the first core of a result TT by 1.1 where it is produced."""
    import xerus_tpu_torch as xt
    c = result.components[0].to_torch()
    result.components[0] = xt.Tensor.from_torch(c * 1.1)
    return result


FAULTS = {
    # a step that returns its state unchanged: the solve returns its
    # start, the rounding its input
    "unchanged": lambda system, k, call: (
        system.x0[k].copy() if hasattr(system, "x0") else system.X[k].copy()),
    # an answer altered where it is produced
    "altered": lambda system, k, call: _alter(system, call(k)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_makes_correct_false(tmp_path, monkeypatch, cell, fault):
    import importlib
    root = tiny_root(tmp_path)
    family = harness.load_cell(REPO, cell)[2]["family"]
    drv = importlib.import_module(f"perfbench.drivers.{family}")
    good = harness.run_cell(root, cell, 21, 0.2, False, CPU, 0.0)
    assert good["correct"] is True
    original = drv.System.call

    def broken(self, k):
        return FAULTS[fault](self, k, lambda j: original(self, j))

    monkeypatch.setattr(drv.System, "call", broken)
    bad = harness.run_cell(root, cell, 21, 0.2, False, CPU, 0.0)
    assert bad["correct"] is False
    assert bad["failed"] >= 1


@pytest.mark.parametrize("cell", ROUND_CELLS)
def test_a_wrong_subspace_makes_correct_false(tmp_path, monkeypatch, cell):
    """A rounding that keeps each truncated bond's singular vectors 2 to
    target + 1: X carried through its own frames, so the projection gaps
    pass it, and only the truncation excess finds it."""
    import importlib
    root = tiny_root(tmp_path)
    drv = importlib.import_module("perfbench.drivers.tt_round")

    def wrong(self, k):
        cores = [c.to_torch() for c in self.X[k].components]
        return rr.rounding_chain(cores, self.target, skip=1)

    monkeypatch.setattr(drv.System, "call", wrong)
    monkeypatch.setattr(drv.System, "cores", staticmethod(lambda ys: ys))
    bad = harness.run_cell(root, cell, 23, 0.2, False, CPU, 0.0)
    assert bad["correct"] is False
    checks = bad["checks"]
    assert checks["truncation_excess"]["value"] > \
        checks["truncation_excess"]["limit"]
    assert checks["right_projection_gap"]["value"] <= \
        checks["right_projection_gap"]["limit"]


@pytest.mark.parametrize("cell", ROUND_CELLS)
def test_the_planted_faults_fail_on_the_cpu(tmp_path, cell):
    """Each fault of the cell file, in the reference put in the program's
    place, at CPU sizes: not correct."""
    root = tiny_root(tmp_path)
    for name, fault in harness.load_cell(REPO, cell)[4]["faults"].items():
        out = harness.run_cell(root, cell, 29, 0.2, False, CPU, 0.0,
                               control=fault)
        assert out["correct"] is False, (name, out["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,name", CONTROLS)
def test_the_control_fails_on_the_card(cell, name):
    """The cell's control, and each fault its cell file plants, at the
    cell's own sizes, on three seeds: each run must come out not correct
    (about a minute a cell)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell_file = harness.load_cell(REPO, cell)[4]
    control = (cell_file["control"] if name == "control"
               else cell_file["faults"][name])
    dev = torch.device("cuda", 0)
    for seed in (3_100_000_001, 3_100_000_002, 3_100_000_003):
        out = harness.run_cell(REPO, cell, seed, 2.0, False, dev, 0.0,
                               control=control)
        assert out["correct"] is False, (seed, out["checks"])
