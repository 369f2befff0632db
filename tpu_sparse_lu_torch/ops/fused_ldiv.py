"""The ldiv kernels and their host schedule: counterpart of
``tpu_sparse_lu/ops/pallas_ldiv.py``.

The TPU kernel runs the whole ``ldiv`` (perm-in → L levels → U levels →
perm-out) as one serial op stream ``X[dst] = X[src] @ tileᵀ + acc·X[dst]``
because one TensorCore executes it. On the H100 the parallelism is the
width of each dependency wave, so the same work becomes launches of two
hand-written CUDA kernels (``csrc/ldiv.cu``):

* :func:`perm_gather` — ``y[i] = scale[s]·v[s]`` with ``s = idx[i]`` (0 where
  ``s < 0``): perm-in with the row scaling ``Rs`` folded in, and perm-out;
* :func:`wave_apply` — one wave of one level: for every destination block
  ``x[dst] = acc·x[dst] + Σ tile·x[src]``. Each level of a factor is two
  waves, the diagonal wave (``acc=0``, ``src == dst``, tile = ``Dinv_k``)
  and the off-diagonal wave (``acc=1``, tiles stored negated) — the wave
  boundaries ``_tri_ops`` emits on the TPU, without its padding;
* :func:`wave_apply_bf16` — the same wave with a bfloat16 tile bank and a
  float32 carrier (``SolverConfig.stream_dtype="bfloat16"``): each tile
  widens to float32 as it is read, as the TPU kernel widens its bf16 L/U
  stream, and the arithmetic stays float32.

Each wrapper runs its kernel on a CUDA tensor and the plain PyTorch version
beside it (``*_plain``) on a CPU tensor, and raises on anything else. The
plain versions are the reference the kernels are held against.
``perm_gather.LAUNCHES``, ``wave_apply.LAUNCHES`` and
``wave_apply_bf16.LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..symbolic import TriPlan
from ._launch import KERNEL_DTYPES as _KERNEL_DTYPES
from ._launch import check as _check
from ._launch import device_kind as _device_kind
from ._launch import lib as _lib
from ._launch import require as _require
from ._launch import stream as _stream

__all__ = [
    "Wave",
    "build_waves",
    "make_wave",
    "perm_gather",
    "perm_gather_plain",
    "wave_apply",
    "wave_apply_bf16",
    "wave_apply_plain",
]

@dataclasses.dataclass
class Wave:
    """One wave of a level, grouped by destination block (CSR).

    Destination ``dst[d]`` receives the entries ``ptr[d]:ptr[d+1]``, each a
    tile of the factor's tile bank (``ent_tile``) applied to the carrier
    block ``ent_src``; ``ent_row`` is each entry's ``d``. All int32.
    ``blocks``/``tiles`` (set here) are the carrier blocks and bank tiles
    the wave needs, so a launch can check its operands without reading
    the device.
    """

    dst: torch.Tensor
    ptr: torch.Tensor
    ent_tile: torch.Tensor
    ent_src: torch.Tensor
    ent_row: torch.Tensor
    accumulate: bool

    def __post_init__(self):
        # checked once here rather than on every launch
        idx = (self.dst, self.ptr, self.ent_tile, self.ent_src, self.ent_row)
        for t in idx:
            _require(t.dtype == torch.int32 and t.dim() == 1
                     and t.is_contiguous() and t.device == self.dst.device,
                     "wave index arrays must be contiguous int32 vectors "
                     "on one device")
        _require(self.ptr.shape[0] == self.dst.shape[0] + 1
                 and self.ent_src.shape == self.ent_tile.shape
                 == self.ent_row.shape, "inconsistent wave shapes")
        ptr = self.ptr.cpu()
        n_ent = self.ent_tile.shape[0]
        _require(int(ptr[0]) == 0 and int(ptr[-1]) == n_ent
                 and bool((ptr[1:] >= ptr[:-1]).all()),
                 "wave ptr must run from 0 to the entry count")
        blocks = torch.cat([self.dst, self.ent_src]).cpu()
        tiles = self.ent_tile.cpu()
        _require(bool((blocks >= 0).all()) and bool((tiles >= 0).all()),
                 "negative block or tile index in a wave")
        self.blocks = int(blocks.max()) + 1 if blocks.numel() else 0
        self.tiles = int(tiles.max()) + 1 if n_ent else 0


def make_wave(dst, groups, accumulate: bool, device) -> Wave:
    """A :class:`Wave` from destination blocks ``dst`` and, per
    destination, its list of ``(tile, src)`` entries."""
    ptr = np.zeros(len(dst) + 1, dtype=np.int32)
    ptr[1:] = np.cumsum([len(g) for g in groups])
    ent = [e for g in groups for e in g]
    as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32),
                                     device=device)
    return Wave(
        dst=as_t(dst), ptr=as_t(ptr),
        ent_tile=as_t([t for t, _ in ent]),
        ent_src=as_t([s for _, s in ent]),
        ent_row=as_t(np.repeat(np.arange(len(dst)), np.diff(ptr))),
        accumulate=accumulate,
    )


def build_waves(plan: TriPlan, device) -> List[Wave]:
    """The dependency waves of one factor's level schedule.

    Tile ids index the factor's bank ``[Dinv_0..Dinv_K, Off_0..Off_T]``:
    chunk ``k``'s inverse is ``k``, off-diagonal tile ``t`` is ``K+1+t``.
    Only the real ``level_chunk_counts``/``level_tile_counts`` entries are
    read; the padding slots of the level arrays are never touched.
    """
    K = plan.K
    waves = []
    for l in range(plan.num_levels):
        chunks = plan.level_chunks[l, : int(plan.level_chunk_counts[l])]
        chunks = chunks.tolist()
        waves.append(make_wave(chunks, [[(k, k)] for k in chunks], False,
                               device))
        tiles = plan.level_tiles[l, : int(plan.level_tile_counts[l])]
        if tiles.size == 0:
            continue
        by_dst = {}
        for t in sorted(tiles.tolist()):
            by_dst.setdefault(int(plan.tile_brow[t]), []).append(
                (K + 1 + t, int(plan.tile_bcol[t]))
            )
        dst = sorted(by_dst)
        waves.append(make_wave(dst, [by_dst[d] for d in dst], True, device))
    return waves


# ---------------------------------------------------------------------------
# perm_gather
# ---------------------------------------------------------------------------


def perm_gather_plain(v: torch.Tensor, idx: torch.Tensor,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y[i] = scale[idx[i]] * v[idx[i]]``; rows whose index lies outside
    ``[0, Nv)`` are 0."""
    outside = (idx < 0) | (idx >= v.shape[0])
    src = idx.long().masked_fill(outside, 0)
    y = v[src]
    if scale is not None:
        y = y * scale[src, None]
    return y.masked_fill_(outside[:, None], 0)


def perm_gather(v: torch.Tensor, idx: torch.Tensor,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row gather with an optional per-source-row scale.

    ``v`` (Nv, R) float32/float64; ``idx`` (Ny,) int32, rows whose index
    lies outside ``[0, Nv)`` (-1 by convention) come out 0; ``scale``
    (Nv,) of ``v``'s dtype or ``None``. Returns a new (Ny, R) tensor.
    """
    tensors = (v, idx) if scale is None else (v, idx, scale)
    if _device_kind(*tensors) == "cpu":
        return perm_gather_plain(v, idx, scale)
    _require(v.dtype in _KERNEL_DTYPES, f"unsupported dtype {v.dtype}")
    _require(v.dim() == 2 and v.is_contiguous(), "v must be contiguous (Nv, R)")
    _require(idx.dtype == torch.int32 and idx.dim() == 1
             and idx.is_contiguous(), "idx must be contiguous int32 (Ny,)")
    if scale is not None:
        _require(scale.dtype == v.dtype and scale.shape == (v.shape[0],)
                 and scale.is_contiguous(), "scale must be contiguous (Nv,)")
    n_out, R = idx.shape[0], v.shape[1]
    y = torch.empty((n_out, R), dtype=v.dtype, device=v.device)
    fn = getattr(_lib(), f"ldiv_perm_gather_{_KERNEL_DTYPES[v.dtype]}")
    rc = fn(y.data_ptr(), v.data_ptr(), idx.data_ptr(),
            None if scale is None else scale.data_ptr(), v.shape[0], n_out,
            R, _stream(v))
    _check(rc, "perm_gather")
    perm_gather.LAUNCHES += 1
    return y


perm_gather.LAUNCHES = 0


# ---------------------------------------------------------------------------
# wave_apply
# ---------------------------------------------------------------------------


def wave_apply_plain(x: torch.Tensor, tiles_t: torch.Tensor,
                     wave: Wave) -> torch.Tensor:
    """``x[dst] = acc·x[dst] + Σ tile·x[src]`` with a batched matmul and
    ``index_add_``; ``tiles_t`` holds the tiles transposed, of ``x``'s
    dtype or bfloat16 (the tiles a wave reads widen exactly to ``x``'s
    dtype: the plain version of both :func:`wave_apply` and
    :func:`wave_apply_bf16`)."""
    contrib = torch.bmm(tiles_t[wave.ent_tile].to(x.dtype).transpose(1, 2),
                        x[wave.ent_src])
    if wave.accumulate:
        out = x[wave.dst]
    else:
        out = torch.zeros((wave.dst.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
    out.index_add_(0, wave.ent_row, contrib)
    x[wave.dst] = out
    return x


def _check_wave(x: torch.Tensor, tiles_t: torch.Tensor, wave: Wave) -> None:
    """The operand checks of a wave launch on a CUDA tensor."""
    _require(x.dim() == 3 and x.is_contiguous(),
             "x must be a contiguous (blocks, cs, R) carrier")
    cs = x.shape[1]
    _require(tiles_t.dim() == 3 and tiles_t.shape[1:] == (cs, cs)
             and tiles_t.is_contiguous(),
             "tiles_t must be contiguous (n_tiles, cs, cs)")
    _require(cs <= _lib().max_chunk, f"the CUDA ldiv kernel takes "
             f"chunk_size <= {_lib().max_chunk}, got {cs}")


def _launch_wave(name: str, x: torch.Tensor, tiles_t: torch.Tensor,
                 wave: Wave) -> None:
    fn = getattr(_lib(), name)
    rc = fn(x.data_ptr(), tiles_t.data_ptr(), wave.dst.data_ptr(),
            wave.ptr.data_ptr(), wave.ent_tile.data_ptr(),
            wave.ent_src.data_ptr(), wave.dst.shape[0], x.shape[1],
            x.shape[2], int(wave.accumulate), _stream(x))
    _check(rc, name)


def wave_apply(x: torch.Tensor, tiles_t: torch.Tensor,
               wave: Wave) -> torch.Tensor:
    """Apply one wave to the carrier ``x`` (blocks, cs, R) in place.

    ``tiles_t`` (n_tiles, cs, cs) is the factor's tile bank, each tile
    transposed, of ``x``'s dtype. Returns ``x``.
    """
    _require(wave.blocks <= x.shape[0] and wave.tiles <= tiles_t.shape[0],
             "wave indexes past the carrier or the tile bank")
    _require(tiles_t.dtype == x.dtype, f"tiles of {tiles_t.dtype} for a "
             f"{x.dtype} carrier (bfloat16 tiles: wave_apply_bf16)")
    if _device_kind(x, tiles_t, wave.dst) == "cpu":
        return wave_apply_plain(x, tiles_t, wave)
    _require(x.dtype in _KERNEL_DTYPES, f"unsupported dtype {x.dtype}")
    _check_wave(x, tiles_t, wave)
    _launch_wave(f"ldiv_wave_apply_{_KERNEL_DTYPES[x.dtype]}", x, tiles_t,
                 wave)
    wave_apply.LAUNCHES += 1
    return x


wave_apply.LAUNCHES = 0


def wave_apply_bf16(x: torch.Tensor, tiles_t: torch.Tensor,
                    wave: Wave) -> torch.Tensor:
    """:func:`wave_apply` with a bfloat16 tile bank and a float32 carrier
    ``x``, in place; returns ``x``."""
    _require(wave.blocks <= x.shape[0] and wave.tiles <= tiles_t.shape[0],
             "wave indexes past the carrier or the tile bank")
    _require(tiles_t.dtype == torch.bfloat16 and x.dtype == torch.float32,
             f"wave_apply_bf16 takes bfloat16 tiles and a float32 carrier, "
             f"got {tiles_t.dtype}/{x.dtype}")
    if _device_kind(x, tiles_t, wave.dst) == "cpu":
        return wave_apply_plain(x, tiles_t, wave)
    _check_wave(x, tiles_t, wave)
    _launch_wave("ldiv_wave_apply_bf16", x, tiles_t, wave)
    wave_apply_bf16.LAUNCHES += 1
    return x


wave_apply_bf16.LAUNCHES = 0
