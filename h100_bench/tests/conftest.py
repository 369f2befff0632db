"""Fixtures of the benchmark's tests.

``tiny_bench`` is the benchmark with a small copy of each deployment
(``tiny_poisson``, ``tiny_banded``), each cell of the real one repeated on
it with the real cell's traffic and limits, found through a temporary
folder searched before the benchmark's own. Tests that need a CUDA card
carry the ``card`` marker and take the ``card`` fixture, which skips them
without one.
"""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402

TINY = {
    "poisson2d_100": {
        "name": "tiny_poisson", "family": "poisson_2d",
        "matrix": {"nx": 20, "ny": 20},
        "solver": {"chunk_size": 16, "ordering": "nd", "nd_cutoff": 64,
                   "dtype": "float32"},
        "reference": "dense_f64", "control": "tf32_control"},
    "banded_120x30": {
        "name": "tiny_banded", "family": "block_banded",
        "matrix": {"nblocks": 12, "bs": 6, "matrix_seed": 0},
        "solver": {"chunk_size": 16, "ordering": "colamd",
                   "dtype": "float32"},
        "reference": "dense_f64", "control": "tf32_control"},
    "banded_1600x64": {
        "name": "tiny_band", "family": "block_banded",
        "matrix": {"nblocks": 16, "bs": 8, "matrix_seed": 0},
        "solver": {"chunk_size": 16, "ordering": "colamd",
                   "dtype": "float32"},
        "reference": "banded_f64", "control": "banded_tf32_control"},
}
# limits of the small copies where the cell's own do not separate there:
# on the CPU, tiny_band.solve reads fwd_err <= 4.3e-7 and bwd_err <= 1.2e-8
# from the program over six seeds, and fwd_err >= 7.9e-5, bwd_err >= 3.0e-6
# from the control over three (the cell's own bwd_err limit, 1e-8, is set
# from its full size, where the program reads 3.8e-10)
TINY_LIMITS = {"tiny_band.solve": {"fwd_err": 1e-5, "bwd_err": 5e-8}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.fixture
def tiny_bench(tmp_path):
    """(Bench, names of the tiny cells)."""
    spec = copy.deepcopy(harness.Bench.load(ROOT).spec)
    (tmp_path / "configs").mkdir()
    (tmp_path / "limits").mkdir()
    cells = []
    for orig, cfg in TINY.items():
        (tmp_path / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
        for w in [w for w in spec["workloads"] if w["config"] == orig]:
            name = w["name"].replace(orig, cfg["name"])
            spec["workloads"].append(dict(w, name=name, config=cfg["name"]))
            limits = TINY_LIMITS.get(name) or harness.Bench.load(ROOT).data(
                "limits", w["name"])
            (tmp_path / "limits" / f"{name}.json").write_text(
                json.dumps(limits))
            for m in spec["end_to_end"] + spec["per_layer"]:
                if w["name"] in m.get("workloads", []):
                    m["workloads"].append(name)
            cells.append(name)
    return harness.Bench(spec, dirs=[tmp_path, harness.HERE]), cells
