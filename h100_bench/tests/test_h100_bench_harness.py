"""The benchmark's harness on the CPU: the registry, the work counts, the
frozen generators, the trace reduction, the guards, and a run of each
cell on a small copy of its deployment."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp

from h100_bench import harness, reduce, work
from h100_bench.tests.conftest import ROOT

BENCH = harness.Bench.load(ROOT)


def test_every_name_is_found():
    spec = BENCH.spec
    for c in spec["configs"]:
        cfg = BENCH.data("configs", c["name"])
        assert (ROOT / c["file"]).is_file() and cfg["name"] == c["name"]
        assert hasattr(BENCH.module("families", cfg["family"]), "build")
        assert hasattr(BENCH.module("reference", cfg["reference"]), "solve")
    for w in spec["workloads"]:
        traffic = BENCH.data("traffic", w["traffic"])
        assert hasattr(BENCH.module("entries", traffic["entry"]), "make")
        limits = BENCH.data("limits", w["name"])
        assert limits and set(limits) <= {"fwd_err", "bwd_err"}
        for trace in (False, True):
            assert BENCH.metrics(w["name"], trace)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(BENCH.module("metrics", m["name"]).read)


def test_metrics_of_a_cell():
    e2e = {m["name"] for m in BENCH.metrics("poisson2d_100.solve", False)}
    assert e2e == {"solve_step_ms", "solve_step_p95_ms", "setup_s"}
    layer = {m["name"] for m in BENCH.metrics("banded_120x30.refactor_solve",
                                              True)}
    assert "construct_s" in layer and "elim_fused_roofline" in layer
    assert not any(n.endswith(".solve") for n in layer)


def test_a_new_config_is_found_without_an_edit(tiny_bench):
    bench, cells = tiny_bench
    assert bench.data("configs", "tiny_poisson")["matrix"] == {"nx": 20,
                                                              "ny": 20}
    assert bench.data("configs", "poisson2d_100")["matrix"]["nx"] == 100
    assert "tiny_banded.refactor_solve" in cells
    with pytest.raises(FileNotFoundError):
        bench.data("configs", "no_such_config")


@pytest.mark.parametrize("cell", ["tiny_poisson.solve", "tiny_banded.solve",
                                  "tiny_band.solve",
                                  "tiny_poisson.refactor_solve",
                                  "tiny_banded.refactor_solve"])
def test_a_run_of_each_cell_on_the_cpu(tiny_bench, cell):
    bench, _ = tiny_bench
    r = harness.run_cell(bench, cell, 2 ** 31 + 11, 0.3, False, "cpu",
                         harness.time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    names = {m["name"] for m in bench.metrics(cell, False)}
    assert set(r["metrics"]) == names
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_the_ring_is_the_seeds():
    A = BENCH.module("families", "poisson_2d").build(nx=6, ny=5)
    traffic = {"rhs": 3, "rhs_ring": 4, "value_ring": 5, "value_scale": 0.05}
    import torch

    r1, r2, r3 = (harness.Ring.make(A, traffic, s, "cpu", torch.float32)
                  for s in (2 ** 33 + 5, 2 ** 33 + 5, 6))
    assert torch.equal(r1.b, r2.b) and torch.equal(r1.values, r2.values)
    assert not torch.equal(r1.b, r3.b)
    # the values are the seed's too: each seed draws its own changes
    assert not torch.equal(r1.values, r3.values)
    a0 = torch.as_tensor(A.data, dtype=torch.float64)
    rel = r3.values.double() / a0 - 1.0
    assert rel.abs().max() < 0.05 * 6 and rel.std() > 0.05 * 0.5
    a, b = r1.inputs(6)
    assert torch.equal(a, r1.values[1]) and torch.equal(b, r1.b[2])


def _dense_lu_patterns(A):
    """L and U of a no-pivot dense LU, as sparse patterns."""
    M = A.toarray().astype(np.float64)
    n = M.shape[0]
    for k in range(n - 1):
        M[k + 1:, k] /= M[k, k]
        M[k + 1:, k + 1:] -= np.outer(M[k + 1:, k], M[k, k + 1:])
    return (sp.csc_matrix(np.tril(M, -1) + np.eye(n)),
            sp.csc_matrix(np.triu(M)))


def test_work_matches_a_hand_count():
    # 2 x 2 Poisson, natural order: eliminating 0 fills (1, 2) and (2, 1);
    # L below the diagonal: column 0 rows 1, 2; column 1 rows 2, 3; column
    # 2 row 3; U: the 4 pivots and the mirror image
    A = BENCH.module("families", "poisson_2d").build(nx=2, ny=2)
    A.eliminate_zeros()  # scipy's kron stores a 2 x 2 grid's zeros
    L, U = _dense_lu_patterns(A)
    w = work.count(A, L, U, rhs=3, dtype="float32")
    assert (w.nnz_a, w.nnz_lu) == (12, 5 + 9)
    assert w.elim_flop == 2 * (2 * 2 + 2 * 2 + 1 * 1) + (2 + 2 + 1)
    assert w.ldiv_flop == 2 * 3 * 14
    assert w.ldiv_bytes == 14 * 8 + 2 * 4 * 3 * 4
    assert w.elim_bytes == 2 * 14 * 4
    assert w.assembly_bytes == (12 + 14) * 4
    assert w.ldiv_s == w.ldiv_bytes / work.HBM_BYTES_PER_S


def test_frozen_generators_equal_the_programs():
    from tpu_sparse_lu_torch.models import block_banded, poisson_2d

    pairs = [(BENCH.module("families", "poisson_2d").build(nx=7, ny=5),
              poisson_2d(7, 5)),
             (BENCH.module("families", "block_banded").build(
                 nblocks=5, bs=4, matrix_seed=3),
              block_banded(np.random.default_rng(3), 5, 4))]
    for ours, theirs in pairs:
        ours, theirs = sp.csc_matrix(ours), sp.csc_matrix(theirs)
        ours.sort_indices()
        theirs.sort_indices()
        assert np.array_equal(ours.indptr, theirs.indptr)
        assert np.array_equal(ours.indices, theirs.indices)
        assert np.array_equal(ours.data, theirs.data)


def _chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_reduction(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 1000.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "api.ldiv",
         "ts": 1000.0, "dur": 10.0},
        {"ph": "X", "cat": "user_annotation", "name": "sync",
         "ts": 1010.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "ts": 1005.0, "dur": 20.0,
         "name": "void (anonymous namespace)::ldiv_fused_kernel<float, "
                 "float, 4>(float*, int)"},
        {"ph": "X", "cat": "kernel", "ts": 1020.0, "dur": 10.0,
         "name": "void tiles_kernel<float>(float*)"},
        {"ph": "X", "cat": "gpu_memset", "ts": 1070.0, "dur": 10.0,
         "name": "Memset (Device)"},
        {"ph": "X", "cat": "kernel", "ts": 2000.0, "dur": 10.0,
         "name": "outside_the_window"},
    ]
    t = reduce.read_chrome_trace(_chrome(tmp_path, ev), steps=1)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(35e-6)  # 1005-1030 and 1070-1080
    assert t.launches(r"\bldiv_fused_kernel\b") == 1
    assert t.op_s(r"\btiles_kernel\b") == pytest.approx(10e-6)
    gaps = dict(t.idle_gaps())
    # 1000-1005 in api.ldiv, 1030-1070 in sync (middle 1050), 1080-1100
    assert gaps == pytest.approx({"api.ldiv": 5e-6, "sync": 40e-6,
                                  "other": 20e-6})
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["ldiv_fused_kernel<float, float, 4>",
                                   pytest.approx(20e-6)]
    assert reduce.read_chrome_trace(_chrome(tmp_path, ev[1:]), 1) is None


def _run(trace=None):
    w = work.Work(dtype="float32", n=100, rhs=2, nnz_a=300, nnz_lu=1000,
                  elim_flop=5000)
    return harness.Run(setup_s=2.0, construct_s=1.0, steps=4,
                       window_s=0.4, latency_s=np.array([0.1] * 3 + [0.2]),
                       dispatch_s=np.array([0.01, 0.02, 0.03, 0.04]),
                       work=w, trace=trace)


def test_metric_readers():
    read = {m["name"]: BENCH.module("metrics", m["name"]).read
            for m in BENCH.spec["end_to_end"] + BENCH.spec["per_layer"]}
    run = _run()
    assert read["solve_step_ms"](run) == pytest.approx(100.0)
    assert read["refactor_step_p95_ms"](run) == pytest.approx(185.0)
    assert read["host_dispatch_ms.solve"](run) == pytest.approx(25.0)
    assert read["setup_s"](run) == 2.0 and read["construct_s"](run) == 1.0
    assert read["host_dispatch_ms.refactor"](run) == pytest.approx(25.0)
    for name in ("ldiv_fused_roofline.solve", "elim_fused_roofline",
                 "assembly_roofline", "extraction_ms",
                 "device_idle_share.solve"):
        assert read[name](run) is None  # no trace: nothing to read
    ops = [("ldiv_fused_kernel<float>", 0.0, 0.1),
           ("elim_fused_kernel<float>", 0.1, 0.3),
           ("tiles_kernel<float>", 0.3, 0.31),
           ("closure_kernel<float>", 0.31, 0.32),
           ("bank_copy", 0.32, 0.34)]
    traced = _run(reduce.Trace(window_s=0.5, steps=1, ops=ops, spans=[]))
    w = traced.work
    assert read["ldiv_fused_roofline.solve"](traced) == pytest.approx(
        100 * w.ldiv_s / 0.1)
    assert read["elim_fused_roofline"](traced) == pytest.approx(
        100 * w.elim_s / 0.2)
    assert read["assembly_roofline"](traced) == pytest.approx(
        100 * w.assembly_s / 0.02)
    assert read["extraction_ms"](traced) == pytest.approx(20.0)
    assert read["device_idle_share.refactor"](traced) == pytest.approx(32.0)
    assert read["device_idle_share.solve"](traced) == pytest.approx(32.0)


def test_a_metric_kind_is_read_by_its_stem():
    # host_dispatch_ms.<kind> has no file of its own: the stem's reader
    stem = BENCH.module("metrics", "host_dispatch_ms")
    assert BENCH.module("metrics", "host_dispatch_ms.any_new_kind").read(
        _run()) == stem.read(_run())
    with pytest.raises(FileNotFoundError):
        BENCH.module("metrics", "no_such_metric.solve")
    with pytest.raises(FileNotFoundError):
        BENCH.module("entries", "ldiv.solve")


def test_the_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(ROOT / "h100_bench" / "run.py"), "--workload",
         "poisson2d_100.solve", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "no CUDA card" in p.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = types.ModuleType("fake")
    monkeypatch.setitem(sys.modules, "tpu_sparse_lu_torch_fake", fake)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", fake)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_sparse_lu.ops", fake)
    assert harness.forbidden_modules() == ["tpu_sparse_lu"]


def test_the_harness_loads_no_jax():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from h100_bench import harness, readings, reduce, work
from h100_bench.reference import dense_f64, tf32_control
import tpu_sparse_lu_torch
b = harness.Bench.load()
for kind in ("families", "entries", "metrics", "reference"):
    for p in sorted((harness.HERE / kind).glob("*.py")):
        if p.stem != "__init__":
            b.module(kind, p.name[:-3])
print(harness.forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
