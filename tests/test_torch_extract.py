"""The solve banks' extraction (``ops/extract.py``) on the CPU.

* ``extract_banks_plain`` (and ``extract_banks`` on CPU tensors, which
  runs it) equals, bit for bit, the PyTorch route that
  ``refactor_pipeline`` ran inline before the one-launch kernel
  (``_inline`` below, kept as the reference), on the plain elimination's
  store of BASELINE configs 2 and 4 at test size, float32 and float64;
  so does ``refactor_pipeline``.
* A store with no off-diagonal tiles takes its growth from ``udiag``
  alone; a NaN in one off-diagonal tile gives a NaN growth.
* The wrapper's checks refuse mixed devices, a dtype outside
  ``KERNEL_DTYPES``, wrong shapes and non-contiguous inputs before any
  launch; CPU tensors launch nothing.

The kernel itself is held to the plain twin on a card by
``tests/test_torch_extract_card.py``. This file imports no JAX.
"""

from types import SimpleNamespace

import pytest
import torch

import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu_torch.assemble import assemble
from tpu_sparse_lu_torch.models import block_banded, poisson_2d
from tpu_sparse_lu_torch.ops import extract as X
from tpu_sparse_lu_torch.ops.elimination import eliminate
from tpu_sparse_lu_torch.refactor import refactor_pipeline

# BASELINE configs 2 (block-banded, colamd) and 4 (2-D Poisson, nd) at
# test size
CONFIGS = {
    "config2": (lambda rng: block_banded(rng, 12, 10), dict(chunk_size=16)),
    "config4": (lambda rng: poisson_2d(14, 11),
                dict(chunk_size=16, ordering="nd")),
}
OUTPUTS = ("lbank", "ubank", "ldiag", "udiag", "growth")


def _inline(store, linv, uinv, dev):
    """The extraction as ``refactor_pipeline`` ran it inline (with its
    ``_bank``), the reference the twin and the kernel are held to."""
    cs = dev.cs

    def bank(dinv_real, off_real):
        eye = torch.eye(cs, dtype=dinv_real.dtype,
                        device=dinv_real.device)[None]
        zero = torch.zeros_like(eye)
        return torch.cat([dinv_real, eye, -off_real, zero]).transpose(
            1, 2).contiguous()

    eye = torch.eye(cs, dtype=store.dtype, device=store.device)
    diag = store[dev.diag_src]
    ldiag = torch.cat([torch.tril(diag, -1) + eye, eye[None]])
    udiag = torch.cat([torch.triu(diag), eye[None]])
    loff = store[dev.l_off_src]
    uoff = store[dev.u_off_src]
    parts = [udiag.abs().amax()]
    parts += [t.abs().amax() for t in (loff, uoff) if t.numel()]
    growth = torch.stack(parts).amax()
    ls = dev.diag_lvlslot
    lbank = bank(linv.reshape(-1, cs, cs)[ls], loff)
    ubank = bank(uinv.reshape(-1, cs, cs)[ls], uoff)
    return lbank, ubank, ldiag, udiag, growth


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.float64: torch.int64}[t.dtype])


def _same_bits(got, want):
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert g.is_contiguous(), name
        assert torch.equal(_bits(g), _bits(w)), name


def _maps(dev):
    return (dev.diag_src, dev.l_off_src, dev.u_off_src, dev.diag_lvlslot)


def _eliminated(rng, case, dtype):
    """(solver, values, dev, store, linv, uinv): the plain elimination of
    a same-pattern change of the case's matrix."""
    make, cfg = CONFIGS[case]
    A = make(rng)
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(dtype=dtype, **cfg),
                             device="cpu")
    F.enable_device_refactor()
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.05 * rng.standard_normal(A2.data.shape))
    a = torch.as_tensor(A2.tocsc().data, dtype=F.dtype)
    dev = F._refactor_dev
    store, _ = assemble(a, dev.asm, n=dev.n, cs=dev.cs, TF=dev.TF,
                        TF2=dev.TF2, plain=True)
    store, _, linv, uinv = eliminate(store, dev.elim, plain=True)
    return F, a, dev, store, linv, uinv


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_plain_twin_is_the_inline_route(rng, case, dtype):
    _, a, dev, store, linv, uinv = _eliminated(rng, case, dtype)
    assert dev.l_off_src.numel() and dev.u_off_src.numel()
    want = _inline(store, linv, uinv, dev)
    _same_bits(X.extract_banks_plain(store, linv, uinv, *_maps(dev)), want)
    _same_bits(X.extract_banks(store, linv, uinv, *_maps(dev)), want)
    # the bank layout: inverses transposed, I, the negated off-diagonal
    # tiles transposed, 0
    K, cs = dev.diag_src.numel(), dev.cs
    lbank = want[0]
    assert torch.equal(lbank[0], linv.reshape(-1, cs, cs)[
        dev.diag_lvlslot[0]].T)
    assert torch.equal(lbank[K], torch.eye(cs, dtype=store.dtype))
    assert torch.equal(lbank[K + 1], -store[dev.l_off_src[0]].T)
    assert not lbank[-1].any()


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_refactor_pipeline_extracts_the_inline_bits(rng, case):
    F, a, dev, store, linv, uinv = _eliminated(rng, case, "float32")
    want = dict(zip(OUTPUTS, _inline(store, linv, uinv, dev)))
    for plain in (False, True):
        out = refactor_pipeline(a, dev, plain=plain)
        _same_bits([out[k] for k in OUTPUTS], [want[k] for k in OUTPUTS])


def _synthetic(rng, dtype, cs=8, levels=4, K=3, TL=2, TU=3):
    """A random store, inverse stacks and maps of K diagonal tiles and
    TL / TU off-diagonal ones, each store tile read by one map."""
    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)

    perm = torch.as_tensor(rng.permutation(K + TL + TU), dtype=torch.int64)
    return (t(K + TL + TU, cs, cs), t(levels, 1, cs, cs),
            t(levels, 1, cs, cs), perm[:K].clone(),
            perm[K:K + TL].clone(), perm[K + TL:].clone(),
            torch.as_tensor(rng.choice(levels, K, replace=False),
                            dtype=torch.int64))


def _as_dev(cs, maps):
    return SimpleNamespace(cs=cs, **dict(zip(
        ("diag_src", "l_off_src", "u_off_src", "diag_lvlslot"), maps)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_no_offdiagonal_tiles(rng, dtype):
    store, linv, uinv, *maps = _synthetic(rng, dtype, TL=0, TU=0)
    store = torch.cat([store, torch.full((2, 8, 8), 1e6, dtype=dtype)])
    got = X.extract_banks(store, linv, uinv, *maps)
    _same_bits(got, _inline(store, linv, uinv, _as_dev(8, maps)))
    lbank, ubank, ldiag, udiag, growth = got
    assert lbank.shape == ubank.shape == (3 + 2, 8, 8)
    # the tiles no map reads stay outside the growth
    assert float(growth) == float(store[:3].triu().abs().max()) < 1e6


@pytest.mark.parametrize("where", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nan_in_an_offdiagonal_tile_gives_nan_growth(rng, dtype, where):
    store, linv, uinv, *maps = _synthetic(rng, dtype)
    store[maps[where][0], 2, 5] = float("nan")
    got = X.extract_banks(store, linv, uinv, *maps)
    _same_bits(got, _inline(store, linv, uinv, _as_dev(8, maps)))
    assert bool(got[4].isnan())
    assert not bool(got[2].isnan().any() or got[3].isnan().any())


def test_cpu_tensors_launch_nothing(rng):
    X.extract_banks.LAUNCHES = 0
    _, a, dev, *_ = _eliminated(rng, "config4", "float32")
    refactor_pipeline(a, dev)
    X.extract_banks(*_synthetic(rng, torch.float32))
    assert X.extract_banks.LAUNCHES == 0


class _NoLaunch:
    """A kernel library whose entries fail the test: every case below must
    be refused before the launch."""

    max_chunk = 128

    def __getattr__(self, name):
        raise AssertionError(f"{name} reached on a refused call")


def _refused(rng, monkeypatch, change):
    monkeypatch.setattr(X, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(X, "_lib", lambda: _NoLaunch())
    args = list(_synthetic(rng, torch.float32))
    change(args)
    with pytest.raises(ValueError):
        X.extract_banks(*args)


REFUSED = {
    "half": lambda a: a.__setitem__(0, a[0].half()),
    "int": lambda a: a.__setitem__(0, a[0].int()),
    "mixed dtypes": lambda a: a.__setitem__(1, a[1].double()),
    "store 2-D": lambda a: a.__setitem__(0, a[0].reshape(-1, 8)),
    "store not square": lambda a: a.__setitem__(0, a[0][:, :4]
                                                .contiguous()),
    "cs above the kernels'": lambda a: a.__setitem__(
        slice(0, 3), [torch.zeros(2, 129, 129), torch.zeros(1, 129, 129),
                      torch.zeros(1, 129, 129)]),
    "inverse tiles of another cs": lambda a: a.__setitem__(
        1, torch.zeros(4, 4, 4)),
    "linv, uinv differ": lambda a: a.__setitem__(2, a[2][:2].contiguous()),
    "int32 map": lambda a: a.__setitem__(3, a[3].int()),
    "2-D map": lambda a: a.__setitem__(4, a[4][None]),
    "diag maps differ": lambda a: a.__setitem__(6, a[6][:2].contiguous()),
    "store transposed": lambda a: a.__setitem__(0, a[0].transpose(1, 2)),
    "linv strided": lambda a: a.__setitem__(1, torch.zeros(8, 1, 8, 8)[::2]),
    "map strided": lambda a: a.__setitem__(
        5, torch.arange(6, dtype=torch.int64)[::2]),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses_before_launch(rng, monkeypatch, case):
    _refused(rng, monkeypatch, REFUSED[case])


def test_wrapper_refuses_other_devices(rng):
    store, linv, uinv, *maps = _synthetic(rng, torch.float32)
    with pytest.raises(ValueError, match="several devices"):
        X.extract_banks(store, linv.to("meta"), uinv, *maps)
    with pytest.raises(ValueError, match="several devices"):
        X.extract_banks(store, linv, uinv, maps[0].to("meta"), *maps[1:])
    with pytest.raises(ValueError, match="device type 'meta'"):
        X.extract_banks(*(t.to("meta") for t in (store, linv, uinv, *maps)))
    assert X.extract_banks.LAUNCHES == 0


def test_wrapper_launches_once_on_valid_inputs(rng, monkeypatch):
    """Past the checks, one call to the entry of the store's dtype with
    the counts of the maps, and one count in ``LAUNCHES``."""
    calls = []

    class Lib:
        max_chunk = 128

        def extract_banks_f64(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(X, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(X, "_lib", lambda: Lib())
    monkeypatch.setattr(X, "stream", lambda t: 0)
    X.extract_banks.LAUNCHES = 0
    store, linv, uinv, *maps = _synthetic(rng, torch.float64)
    lbank, ubank, ldiag, udiag, growth = X.extract_banks(store, linv, uinv,
                                                         *maps)
    assert X.extract_banks.LAUNCHES == 1 and len(calls) == 1
    assert calls[0][12:] == (3, 2, 3, 8, 4, 8, 0)
    assert lbank.shape == (3 + 2 + 2, 8, 8) and ubank.shape == (8, 8, 8)
    assert ldiag.shape == udiag.shape == (4, 8, 8) and growth.shape == ()
    X.extract_banks.LAUNCHES = 0

