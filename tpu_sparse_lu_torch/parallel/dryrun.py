"""One full step of every mesh engine over ``n_ranks`` processes on the
CPU: counterpart of ``__graft_entry__.dryrun_multichip``.

    python -m tpu_sparse_lu_torch.parallel.dryrun 4

spawns four gloo ranks. Each rank refactorizes on its device with new
values (``ParallelSparseLU._refactor_values``), then solves through the
psum engine (the nested-dissection embedding too), the halo pipeline
(replicated and distributed output) and the data-parallel engine, each
checked by its residual. The spawner joins the ranks under a deadline and
kills the survivors of a failure.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

__all__ = ["dryrun_multichip"]

OK = "DRYRUN_OK"
TIMEOUT = 300.0  # seconds for the whole spawn, start-up included
_MODULE = "tpu_sparse_lu_torch.parallel.dryrun"


def _residual(F, x, b) -> float:
    import numpy as np

    r = (F.matvec(x) - b).double().numpy()
    return float(np.linalg.norm(r) / max(np.linalg.norm(b.double().numpy()),
                                         1e-30))


def _rank(rank: int, world: int, url: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import ParallelSparseLU, SolverConfig
    from ..models import block_banded, poisson_2d
    from .dp import make_dp_ldiv
    from .mesh import initialize_multihost, make_mesh
    from .pipeline_solve import make_pipeline_ldiv
    from .sharded_solve import make_sharded_ldiv

    torch.set_num_threads(1)
    initialize_multihost(url, world, rank, device="cpu",
                         timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh()
        A = poisson_2d(8, 8)
        cfg = SolverConfig(chunk_size=4, tri_mode="inv", dtype="float32")
        F = ParallelSparseLU(A, config=cfg, device="cpu")
        F.enable_device_refactor()
        # numeric refactorization on the device (new values, same pattern)
        rng = np.random.default_rng(1)
        new = A.data * (1.0 + 0.01 * rng.standard_normal(A.data.shape))
        F._refactor_values(torch.as_tensor(new))
        b = torch.as_tensor(rng.random((F.n, world)), dtype=torch.float32)
        errs = {}
        # TP: the level-striped psum engine
        errs["sharded"] = _residual(F, make_sharded_ldiv(F, mesh)(b), b)
        # TP x nd: the nd embedding through the mesh engine
        Fnd = ParallelSparseLU(A, config=SolverConfig(
            chunk_size=4, tri_mode="inv", dtype="float32", ordering="nd"),
            device="cpu")
        errs["sharded_nd"] = _residual(Fnd, make_sharded_ldiv(Fnd, mesh)(b),
                                       b)
        # DP: the panel's columns split over the ranks
        errs["dp"] = _residual(F, make_dp_ldiv(F, mesh)(b).full_tensor(), b)
        # PP/SP: the halo pipeline on a banded operator
        Ab = block_banded(rng, 4 * world, 8)
        Fb = ParallelSparseLU(Ab, config=SolverConfig(
            chunk_size=8, tri_mode="inv", dtype="float32"), device="cpu")
        bb = torch.as_tensor(rng.random((Fb.n, 4)), dtype=torch.float32)
        psolve = make_pipeline_ldiv(Fb, mesh, micro_panels=2)
        if psolve is None:
            raise RuntimeError("pipeline plan refused the banded factor")
        xb = psolve(bb)
        errs["pipeline"] = _residual(Fb, xb, bb)
        # PP/SP with the solution left distributed (no final all_reduce)
        xs = make_pipeline_ldiv(Fb, mesh, micro_panels=2,
                                replicate=False)(bb)
        if xs.to_local().shape[0] * world != xs.shape[0]:
            raise RuntimeError(f"distributed output not sharded: "
                               f"{tuple(xs.shape)}")
        errs["pipeline_distributed"] = float(
            (xs.full_tensor()[: Fb.n] - xb).abs().max())
        bad = {k: v for k, v in errs.items()
               if not v < (1e-5 if k == "pipeline_distributed" else 1e-3)}
        if bad:
            raise RuntimeError(f"rank {rank}: residuals over the bar: {bad}")
        print(f"{OK} rank={rank} " + " ".join(
            f"{k}={v:.1e}" for k, v in errs.items()), flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int) -> str:
    """Run :func:`_rank` in ``n_ranks`` spawned gloo processes (file
    rendezvous in a temporary directory); return their output, or raise
    ``RuntimeError`` with it when a rank fails or the deadline passes."""
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with tempfile.TemporaryDirectory() as tmp:
        url = "file://" + os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", _MODULE, "--rank", str(r), str(n_ranks),
             url], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env) for r in range(n_ranks)]
        outs = []
        deadline = time.monotonic() + TIMEOUT
        try:
            for p in procs:
                left = max(1.0, deadline - time.monotonic())
                outs.append(p.communicate(timeout=left)[0])
        except subprocess.TimeoutExpired:
            outs.append(f"deadline of {TIMEOUT} s passed")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    text = "\n".join(outs)
    if any(p.returncode != 0 for p in procs) or text.count(OK) != n_ranks:
        raise RuntimeError(f"dry run over {n_ranks} ranks failed:\n"
                           f"{text[-6000:]}")
    return text


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        _rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
