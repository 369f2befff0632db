"""One rank of the port's mesh-engine checks (tests/test_torch_parallel.py).

    python _torch_parallel_worker.py <rank> <world> <init_url> <out_dir>

Joins a gloo group of ``world`` CPU ranks, runs every case of
:data:`CASES` through the port's engines and writes what each rank got to
``<out_dir>/rank<r>.npz`` (a case that raised leaves its traceback in
``rank<r>.json``). Imports no JAX: the test process holds the results
against the JAX engines, the port's ``F.ldiv`` and scipy. The inputs are
made from seeds by :func:`problem` and :func:`rhs`, which the test calls
too.
"""

import datetime
import json
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODES = ("inv", "trsm", "inv_refine")
# family -> (matrix, solver config, refactor with perturbed values)
FAMILIES = {
    "poisson": (lambda: _models().poisson_2d(12, 10), {}, False),
    "poisson_nd": (lambda: _models().poisson_2d(12, 10),
                   {"ordering": "nd"}, False),
    "laplace_refactor": (lambda: _models().laplacian_1d(96), {}, True),
    "banded": (lambda: _models().block_banded(np.random.default_rng(3),
                                              32, 16), {}, False),
    "banded_nd": (lambda: _models().block_banded(np.random.default_rng(4),
                                                 24, 8),
                  {"ordering": "nd"}, False),
    "chain_refactor": (lambda: _models().laplacian_1d(256), {}, True),
}
SHARDED = ("poisson", "poisson_nd", "laplace_refactor")
PIPELINE = ("banded", "banded_nd", "chain_refactor")
R = 3  # right-hand sides of the engine cases
MICRO = 2


def _models():
    from tpu_sparse_lu_torch import models

    return models


def problem(family):
    """``(A0, A, cfg)``: the matrix the solver is built on, the one it
    solves (after a host ``refactor`` when the family says so) and the
    config keywords; float64 and chunk_size 8 throughout."""
    make, cfg, refactor = FAMILIES[family]
    A0 = make().tocsc()
    A = A0
    if refactor:
        A = A0.copy()
        rng = np.random.default_rng(11)
        A.data = A.data * (1.0 + 0.05 * rng.standard_normal(A.data.shape))
    return A0, A, dict(chunk_size=8, dtype="float64", **cfg)


def rhs(n, r, seed=5):
    return np.random.default_rng(seed).random((n, r))


def case_names():
    names = [f"{e}/{f}/{m}" for e, fams in (("sharded", SHARDED),
                                            ("pipeline", PIPELINE))
             for f in fams for m in MODES]
    return names + ["sharded_output", "pipeline_distributed",
                    "pipeline_single_rhs", "pipeline_pair", "dp",
                    "allocate_shared", "apply_perm_boundary",
                    "replicate_to_mesh"]


def _solver(family, mode):
    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig

    A0, A, cfg = problem(family)
    F = ParallelSparseLU(A0, config=SolverConfig(tri_mode=mode, **cfg),
                         device="cpu")
    if A is not A0:
        F.refactor(A)
    return A, F


def run_case(name, mesh, d, D):
    """The arrays rank ``d`` of ``D`` keeps for case ``name``."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from tpu_sparse_lu_torch import allocate_shared
    from tpu_sparse_lu_torch.parallel._comm import Collectives
    from tpu_sparse_lu_torch.parallel.dp import make_dp_ldiv
    from tpu_sparse_lu_torch.parallel.mesh import mesh_axis
    from tpu_sparse_lu_torch.parallel.pipeline_solve import (
        build_perm_blocks,
        build_pipeline_plan,
        build_sharded_perm_plan,
        make_pipeline_ldiv,
        pipeline_ldiv_pair,
        pipeline_tri_solve,
        rank_pipeline,
        sharded_apply_perm,
    )
    from tpu_sparse_lu_torch.parallel.sharded_solve import make_sharded_ldiv
    from tpu_sparse_lu_torch.solve import block_rhs

    parts = name.split("/")
    if parts[0] == "sharded" and len(parts) == 3:
        A, F = _solver(parts[1], parts[2])
        solve = make_sharded_ldiv(F, mesh)
        x = solve(rhs(A.shape[0], R))
        return {"x": x.numpy(), "all_reduce":
                np.int64(solve.collectives.counts["all_reduce"])}
    if parts[0] == "pipeline" and len(parts) == 3:
        A, F = _solver(parts[1], parts[2])
        solve = make_pipeline_ldiv(F, mesh, micro_panels=MICRO)
        if solve is None:
            return {"none": np.int64(1)}
        return {"x": solve(rhs(A.shape[0], R)).numpy()}
    if name == "sharded_output":
        A, F = _solver("poisson", "trsm")
        xs = make_sharded_ldiv(F, mesh, shard_output=True)(
            rhs(A.shape[0], R))
        return {"local": xs.to_local().numpy(),
                "full": xs.full_tensor().numpy(),
                "sharded": np.int64(xs.placements[0] == Shard(0))}
    if name == "pipeline_distributed":
        A, F = _solver("banded", "trsm")
        solve = make_pipeline_ldiv(F, mesh, micro_panels=MICRO,
                                   replicate=False)
        xs = solve(rhs(A.shape[0], R))
        return {"local": xs.to_local().numpy(),
                "full": xs.full_tensor().numpy(),
                "sharded": np.int64(xs.placements[0] == Shard(0)),
                "all_reduce": np.int64(
                    solve.collectives.counts["all_reduce"])}
    if name == "pipeline_single_rhs":
        A, F = _solver("chain_refactor", "trsm")
        b = rhs(A.shape[0], 1)[:, 0]
        return {"x": make_pipeline_ldiv(F, mesh)(b).numpy(),
                "xs": make_pipeline_ldiv(F, mesh, replicate=False)(b)
                .full_tensor().numpy()}
    if name == "pipeline_pair":
        A, F = _solver("banded", "trsm")
        group, D_, d_ = mesh_axis(mesh, "chunks")
        comm = Collectives(group, D_, d_)
        comm.reset()
        plan = F.plan
        lrp = rank_pipeline(plan.lplan, build_pipeline_plan(plan.lplan, D),
                            d, F.device)
        urp = rank_pipeline(plan.uplan, build_pipeline_plan(plan.uplan, D),
                            d, F.device)
        b = torch.as_tensor(rhs(A.shape[0], 8))
        xw = block_rhs(b, A.shape[0], plan.lplan.K, plan.cs)
        N = F._numeric
        seq = pipeline_tri_solve(comm, lrp, N.ldata, xw, micro_panels=4,
                                 tri_mode="trsm")
        seq = pipeline_tri_solve(comm, urp, N.udata, seq, micro_panels=4,
                                 tri_mode="trsm")
        pair = pipeline_ldiv_pair(comm, lrp, N.ldata, urp, N.udata, xw,
                                  micro_panels=4, tri_mode="trsm")
        return {"seq": seq.numpy(), "pair": pair.numpy()}
    if name == "dp":
        A, F = _solver("poisson", "trsm")
        solve = make_dp_ldiv(F, mesh)
        X = solve(rhs(A.shape[0], 4 * D))
        try:
            solve(rhs(A.shape[0], 4 * D + 1))
            refused = 0
        except ValueError:
            refused = 1
        return {"local": X.to_local().numpy(),
                "full": X.full_tensor().numpy(),
                "collectives": np.int64(
                    sum(solve.collectives.counts.values())),
                "refused_indivisible": np.int64(refused)}
    if name == "allocate_shared":
        rep = allocate_shared((64, 8), torch.float64, mesh=mesh)
        sh = allocate_shared((64, 8), torch.float64, mesh=mesh,
                             spec=[Shard(0)])
        return {"rep_local": rep.to_local().numpy(),
                "sh_local": sh.to_local().numpy(),
                "rep_is": np.int64(rep.placements[0] == Replicate()),
                "sh_is": np.int64(sh.placements[0] == Shard(0))}
    if name == "apply_perm_boundary":
        cs, Kl = 8, 3
        K = D * Kl
        n = K * cs
        perm = np.minimum(np.arange(n) + cs, n - 1)
        perm[-cs:] = np.arange(n - cs, n)
        spp = build_sharded_perm_plan(build_perm_blocks(perm, n, cs), Kl, D)
        group, D_, d_ = mesh_axis(mesh, "chunks")
        comm = Collectives(group, D_, d_)
        comm.reset()
        v = rhs(n, 3, seed=9)
        x_loc = torch.as_tensor(v.reshape(K, cs, 3)[d * Kl:(d + 1) * Kl])
        out = sharded_apply_perm(comm, spp, torch.as_tensor(spp.row_src[d]),
                                 x_loc)
        return {"out": out.numpy(), "use": np.asarray(spp.use_dir, np.int64),
                "send_recv": np.int64(comm.counts["send_recv"])}
    if name == "replicate_to_mesh":
        from tpu_sparse_lu_torch.parallel.mesh import replicate_to_mesh

        mine = {"a": torch.full((3, 2), float(d)),
                "b": (torch.arange(4) * (d + 1),)}
        got = replicate_to_mesh(mine, mesh)
        return {"a": got["a"].numpy(), "b": got["b"][0].numpy(),
                "kept": mine["a"].numpy()}
    raise KeyError(name)


def main(rank, world, url, out_dir):
    import torch
    import torch.distributed as dist

    from tpu_sparse_lu_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
    )

    torch.set_num_threads(1)
    initialize_multihost(url, world, rank, device="cpu",
                         timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh()
    arrays, errors = {}, {}
    for name in case_names():
        try:
            for k, v in run_case(name, mesh, rank, world).items():
                arrays[f"{name}|{k}"] = v
        except Exception:  # noqa: BLE001 — reported per case by the test
            errors[name] = traceback.format_exc()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(errors, f)
    dist.destroy_process_group()
    print(f"WORKER_DONE rank={rank} errors={len(errors)}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
