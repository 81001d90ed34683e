"""Fused center-decode: the CUDA kernel ``csrc/decode.cu`` and its wrapper.

Port of the JAX package's one Pallas kernel (``ops/pallas/decode.py``,
``_decode_kernel`` via ``fused_center_decode``). The kernel computes, per
crop, the chain of :func:`~unmore_tpu_torch.ops.fields.center_singularity_scores`
(union, three 9x9 erosions, 5x5 anti-center correlation, border, max and
first-occurrence argmax) in three launches: a pass over every pixel that
writes the union and packs its bits, one CTA per band of
:data:`BAND_ROWS` rows of a crop that erodes the bits and scores its band
into a per-crop key, and a pass that decodes the keys; see the note at the
top of ``csrc/decode.cu``.

For a CPU tensor the wrapper runs that plain version; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from unmore_tpu_torch.ops.cuda_build import load_library
from unmore_tpu_torch.ops.fields import _anti_center_kernel, center_singularity_scores
from unmore_tpu_torch.utils import tracing

MAX_SIZE = 256  # largest crop side the kernel takes
MAX_ANTI_K = 21  # the taps travel by value among the kernel's parameters (< 4 KB)
BAND_ROWS = 8  # rows of a crop per CTA of the scoring pass: 16 CTAs a crop at S=128 (PERF.md)
STRIP_ROWS = 4  # rows a thread scores at once; BAND_ROWS is a multiple of it


def bands(S: int) -> tuple[int, int]:
    """(rows per band, bands per crop) of the scoring pass: band ``b``
    covers rows ``[b * rows, min((b + 1) * rows, S))``."""
    return BAND_ROWS, -(-S // BAND_ROWS)


def smem_bytes(S: int, anti_k: int) -> int:
    """Dynamic shared memory of a scoring CTA: the crop's packed mask and
    its row-pass copy, then planar cy and cx of a band's rows with an
    ``anti_k // 2`` halo on every side."""
    words, halo = -(-S // 32), 2 * (anti_k // 2)
    return 4 * (2 * S * words + 2 * (BAND_ROWS + halo) * (S + halo))


def workspace_bytes(B: int, S: int) -> int:
    """Scratch of one call: a 64-bit argmax key per crop, then the packed
    union bits, ``[B, S, ceil(S/32)]`` words."""
    return 8 * B + 4 * B * S * -(-S // 32)


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    lib = load_library("decode")
    fn = lib.unmore_fused_center_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.unmore_decode_init.restype = ctypes.c_int
    lib.unmore_decode_init.argtypes = []
    lib.unmore_cuda_error_string.restype = ctypes.c_char_p
    lib.unmore_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str):
    if err:
        raise RuntimeError(f"decode kernel {what} failed: {lib.unmore_cuda_error_string(err).decode()} ({err})")


@functools.lru_cache(maxsize=None)
def _library_on(device_index: int) -> ctypes.CDLL:
    """The library, with the scoring pass's shared-memory limit raised to
    the device's maximum: once per device, not per call."""
    lib = _load_library()
    with torch.cuda.device(device_index):
        _raise_on(lib, lib.unmore_decode_init(), "set-up")
    return lib


@functools.lru_cache(maxsize=8)
def _host_taps(anti_k: int) -> tuple[np.ndarray, int]:
    """[anti_k, anti_k, 2] f32 tap weights (wy, wx) in host memory and their
    address: the C launcher copies them into the kernel's parameters."""
    taps = np.ascontiguousarray(_anti_center_kernel(anti_k)[..., 0])
    return taps, taps.ctypes.data


def _check(sdf_maps: torch.Tensor, center_fields: torch.Tensor, erode_k: int, anti_k: int):
    if sdf_maps.dtype != torch.float32 or center_fields.dtype != torch.float32:
        raise TypeError(f"fused_center_decode takes float32, got {sdf_maps.dtype}/{center_fields.dtype}")
    if sdf_maps.ndim != 3 or sdf_maps.shape[1] != sdf_maps.shape[2]:
        raise ValueError(f"sdf_maps must be [B, S, S], got {tuple(sdf_maps.shape)}")
    if tuple(center_fields.shape) != (*sdf_maps.shape, 2):
        raise ValueError(
            f"center_fields must be {(*sdf_maps.shape, 2)}, got {tuple(center_fields.shape)}"
        )
    if not (sdf_maps.is_contiguous() and center_fields.is_contiguous()):
        raise ValueError("fused_center_decode needs contiguous inputs")
    if center_fields.device != sdf_maps.device:
        raise ValueError("sdf_maps and center_fields must be on one device")
    S = sdf_maps.shape[1]
    if not 0 < S <= MAX_SIZE:
        raise ValueError(f"fused_center_decode supports 0 < S <= {MAX_SIZE}, got S={S}")
    if sdf_maps.numel() >= 2**31:
        raise ValueError("fused_center_decode takes fewer than 2**31 pixels a call")
    if erode_k < 1 or anti_k < 1 or erode_k % 2 == 0 or anti_k % 2 == 0:
        raise ValueError("erode_k and anti_k must be odd and positive")
    if anti_k > MAX_ANTI_K:
        raise ValueError(f"fused_center_decode supports anti_k <= {MAX_ANTI_K}, got {anti_k}")


def fused_center_decode(
    sdf_maps: torch.Tensor,
    center_fields: torch.Tensor,
    border: int = 10,
    erode_k: int = 9,
    erode_rounds: int = 3,
    anti_k: int = 5,
):
    """Fused equivalent of ``center_singularity_scores``.

    sdf_maps [B, S, S] f32; center_fields [B, S, S, 2] f32 (dy, dx).
    Returns (max_scores [B] f32, argmax_yx [B, 2] int32, union [B, S, S]
    int32). CPU tensors run the plain version; CUDA tensors launch the
    kernel's three passes on the current stream and count one call in the
    tracer's ``ops.decode.launches``.
    """
    _check(sdf_maps, center_fields, erode_k, anti_k)
    if sdf_maps.device.type == "cpu":
        return center_singularity_scores(
            sdf_maps, center_fields, border=border, erode_kernel=erode_k,
            erode_rounds=erode_rounds, anti_kernel=anti_k,
        )
    if sdf_maps.device.type != "cuda":
        raise ValueError(f"fused_center_decode runs on cpu or cuda, got {sdf_maps.device}")
    dev = sdf_maps.device
    lib = _library_on(dev.index)
    B, S, _ = sdf_maps.shape
    band_rows, n_bands = bands(S)
    max_scores = torch.empty((B,), dtype=torch.float32, device=dev)
    argmax_yx = torch.empty((B, 2), dtype=torch.int32, device=dev)
    union = torch.empty((B, S, S), dtype=torch.int32, device=dev)
    workspace = torch.empty((workspace_bytes(B, S),), dtype=torch.uint8, device=dev)
    current = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(dev):
        err = lib.unmore_fused_center_decode(
            sdf_maps.data_ptr(), center_fields.data_ptr(), _host_taps(anti_k)[1],
            max_scores.data_ptr(), argmax_yx.data_ptr(), union.data_ptr(), workspace.data_ptr(),
            B, S, border, erode_k, erode_rounds, anti_k, band_rows, n_bands, smem_bytes(S, anti_k),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "launch")
    tracing.count("ops.decode.launches")
    return max_scores, argmax_yx, union
