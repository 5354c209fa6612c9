"""The eval conv epilogue: hand-written CUDA for Hopper, bound with ctypes
and registered as a custom op.

The op ``torch.ops.laughter_icsi_torch.bn_act`` (registered when this
module is imported) computes ``relu(bn(y + bias) + residual)`` on a conv's
output ``y`` in one pass, each term optional: the conv bias, eval
BatchNorm from its raw tensors (``models/layers.batch_norm``'s expression),
a residual of ``y``'s shape (a strided view is fine) and the ReLU.  Each
step rounds to ``y``'s dtype as the eager chain of PyTorch ops does, so
the output equals that chain's bit for bit (``csrc/bn_act.cu`` says how).
``models/layers.conv_bn_act`` calls it for a CUDA tensor outside train
mode, and the composed chain otherwise: that chain is the plain version,
which the CPU tests and the comparison with the JAX package run.

``y`` is dense in either memory format, NCHW or channels-last (NHWC: the
bf16 classify step's, whose cuDNN convs read and write NHWC), and the
output takes ``y``'s format.  With ``pad_top`` / ``pad_bottom`` the output
has that many zero rows above and below the result (along H), written by
the same launch: the input of a conv that pads in time on one side, such
as the shared stem's window-edge band convs, with no separate pad pass.  The kernel picks its form from ``y``'s strides
(:func:`layout`; a tensor dense in both, as one with a single channel is,
counts as NCHW).  In NHWC a residual whose channel stride is 1 and whose
other strides are multiples of 8 bf16 (4 float32) elements at a 16-byte
aligned base, such as a crop along H of a channels-last tensor, takes the
kernel's 16-byte loads; a residual laid out as ``y`` does in either form;
any other residual takes scalar loads (:func:`launch_args`).

The op has a kernel for CUDA tensors only; an exported graph
(``export.py``) calls it as the live model does.
A CUDA tensor the kernel does not take raises.  The op's fake gives the
output's shape, dtype and memory format, which lets ``torch.export`` trace
it.  The kernel is built on first use by ``ops/nvcc.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from laughter_detection_icsi_tpu_torch.ops import nvcc

#: Kernel launches so far (the wrapper adds one per launch, nowhere else):
#: lets a run show that its main path went through the kernel.  Those of
#: its NHWC form are counted again in ``launches_nhwc``, those that write
#: zero rows around their output in ``launches_padded``.
launches = 0
launches_nhwc = 0
launches_padded = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The C entry point's flags.
_BIAS, _NORM, _RESIDUAL, _RELU = 1, 2, 4, 8
#: How the kernel reads the residual: at its strides one element at a time,
#: laid out as y (16-byte loads), or one NHWC pixel's channels at a time.
_RES_STRIDED, _RES_DENSE, _RES_PIXEL = 0, 1, 2


def build():
    """Compile ``csrc/bn_act.cu`` unless this source is already built.
    Returns the library's path."""
    return nvcc.build("bn_act.cu")


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.bn_act_launch.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, ll, ll, ll, ll,
                                  i, i, f, i, i, i, i, p]
    lib.bn_act_launch.restype = ctypes.c_int
    return lib


def _check(y: torch.Tensor, name: str, t: Optional[torch.Tensor], shape) -> None:
    if t is None:
        return
    if t.device != y.device or t.dtype != y.dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"bn_act: {name} must be {y.dtype} {tuple(shape)} on {y.device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def layout(y: torch.Tensor) -> str:
    """The kernel's form for ``y``: "nchw" for a contiguous ``y``, "nhwc"
    for one contiguous in channels-last; anything else raises."""
    if y.ndim == 4 and y.is_contiguous():
        return "nchw"
    if y.ndim == 4 and y.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    raise ValueError(f"bn_act wants y contiguous in NCHW or channels-last, got shape "
                     f"{tuple(y.shape)} strides {y.stride()}")


def padded_shape(y: torch.Tensor, pad_rows: Tuple[int, int]) -> Tuple[int, ...]:
    """The output's shape: ``y``'s [n, c, h, w] with ``pad_rows = (top,
    bottom)`` zero rows added along H.  A negative pad, or a ``y`` of
    another rank, raises."""
    top, bottom = pad_rows
    if y.ndim != 4 or top < 0 or bottom < 0:
        raise ValueError(f"bn_act pads a 4-d y by rows >= 0, got y of shape {tuple(y.shape)} "
                         f"and pad_rows {tuple(pad_rows)}")
    n, c, h, w = y.shape
    return (n, c, top + h + bottom, w)


def _output(y: torch.Tensor, pad_rows: Tuple[int, int]) -> torch.Tensor:
    """An empty output for ``y``, dense in ``y``'s memory format."""
    shape = padded_shape(y, pad_rows)
    if not any(pad_rows):
        return torch.empty_like(y)
    fmt = torch.channels_last if layout(y) == "nhwc" else torch.contiguous_format
    return torch.empty(shape, dtype=y.dtype, device=y.device, memory_format=fmt)


def launch_args(y: torch.Tensor, residual: Optional[torch.Tensor],
                pad_rows: Tuple[int, int] = (0, 0)) -> Tuple[int, ...]:
    """The launch's geometry for ``y``, its residual and the output's zero
    rows: ``(n, c, h, w, rs0, rs1, rs2, rs3, res_mode, wide, nhwc, top,
    bottom)``, ``rs`` the residual's strides.  ``wide``: ``y`` is 16-byte
    aligned (the output, a fresh allocation, is too), so the kernel moves
    16 bytes a thread; it stores the padded output 16 bytes a thread where
    a row (``w``, or ``w * c`` in NHWC) is a whole number of vectors."""
    padded_shape(y, pad_rows)
    nhwc = layout(y) == "nhwc"
    vec = 16 // y.element_size()
    wide = y.data_ptr() % 16 == 0
    rs = residual.stride() if residual is not None else (0, 0, 0, 0)
    mode = _RES_STRIDED
    if residual is not None and wide and residual.data_ptr() % 16 == 0:
        if rs == y.stride():
            mode = _RES_DENSE
        elif (nhwc and rs[1] == 1 and y.shape[1] % vec == 0
              and all(s % vec == 0 for s in (rs[0], rs[2], rs[3]))):
            mode = _RES_PIXEL
    return (*y.shape, *rs, mode, int(wide), int(nhwc), *pad_rows)


@torch.library.custom_op("laughter_icsi_torch::bn_act", mutates_args=(), device_types="cuda")
def _bn_act_launch(
    y: torch.Tensor, bias: Optional[torch.Tensor], weight: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], mean: Optional[torch.Tensor], var: Optional[torch.Tensor],
    residual: Optional[torch.Tensor], relu: bool, eps: float, pad_top: int = 0,
    pad_bottom: int = 0,
) -> torch.Tensor:
    """The op on a CUDA tensor: one launch of the kernel (built on first
    use), counted in ``launches`` (and, in its NHWC form, in
    ``launches_nhwc``; with zero rows, in ``launches_padded``).
    ``weight``, ``shift`` (BN's bias), ``mean`` and ``var`` come together
    or not at all."""
    global launches, launches_nhwc, launches_padded
    if y.dtype not in _DTYPES:
        raise TypeError(f"bn_act takes float32 or bfloat16, got {y.dtype}")
    layout(y)
    norm = (weight, shift, mean, var)
    if any(t is None for t in norm) != all(t is None for t in norm):
        raise ValueError("bn_act: weight, shift, mean and var come together or not at all")
    c = y.shape[1]
    for name, t in (("bias", bias), ("weight", weight), ("shift", shift), ("mean", mean),
                    ("var", var)):
        _check(y, name, t, (c,))
    _check(y, "residual", residual, y.shape)
    out = _output(y, (pad_top, pad_bottom))  # in y's memory format
    if y.numel() == 0:
        return out.zero_()
    if out.numel() >= 2**31:
        raise ValueError(f"bn_act takes fewer than 2**31 elements, got {out.numel()}")
    flags = ((_BIAS if bias is not None else 0) | (_NORM if var is not None else 0)
             | (_RESIDUAL if residual is not None else 0) | (_RELU if relu else 0))
    n, c, h, w, *rs, mode, wide, nhwc, top, bottom = launch_args(y, residual,
                                                                 (pad_top, pad_bottom))
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(y.device):
        err = _library().bn_act_launch(
            _DTYPES[y.dtype], y.data_ptr(), out.data_ptr(), ptr(bias), ptr(weight),
            ptr(shift), ptr(mean), ptr(var), ptr(residual), n, c, h, w, *rs, mode, flags, eps,
            wide, nhwc, top, bottom, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed (cudaError {err})")
    launches += 1
    launches_nhwc += nhwc
    launches_padded += top + bottom > 0
    return out


@_bn_act_launch.register_fake
def _bn_act_fake(y, bias, weight, shift, mean, var, residual, relu, eps, pad_top=0,
                 pad_bottom=0) -> torch.Tensor:
    """``y``'s shape with the zero rows, dtype and memory format."""
    return _output(y, (pad_top, pad_bottom))
