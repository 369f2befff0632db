"""Launch plumbing shared by the kernel wrappers: the library, the raw
stream handle, the launch check and argument checks."""

from __future__ import annotations

import torch

from ..trace import _local, _thread_state, _unspanned

__all__ = ["KERNEL_DTYPES", "lib", "stream", "check", "require",
           "device_kind"]

KERNEL_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def lib():
    from . import _build

    return _build.load()


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s device: the lookup
    Triton's launcher makes, ~0.2 µs a call where
    ``torch.cuda.current_stream(device).cuda_stream`` takes ~6 µs
    (measured on an H100 host), paid on every launch."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(rc: int, what: str) -> None:
    """Raise on a failed launch (or a capacity query's error); count a
    launch that succeeded in the calling thread's open spans
    (``trace.py``), or under ``lu.unspanned`` when none is open."""
    if rc != 0:
        msg = lib().ldiv_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {rc})")
    # trace.py's per-thread state, counted here rather than through a call
    # into trace.py: this runs on every launch, and the call measured up
    # to ~0.03 µs more a span and its launch on an H100 host
    try:
        st = _local.state
    except AttributeError:
        st = _thread_state()
    st.launches += 1
    if not st.depth:
        _unspanned(st)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def device_kind(first: torch.Tensor, *rest: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"`` when every tensor lies on that one device."""
    dev = first.device
    for t in rest:
        if t.device != dev:  # no message built on the launch path
            raise ValueError(
                f"tensors on several devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device type {dev.type!r}")
    return dev.type
