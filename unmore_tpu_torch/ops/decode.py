"""Fused center-decode: the CUDA kernel ``csrc/decode.cu`` and its wrapper.

Port of the JAX package's one Pallas kernel (``ops/pallas/decode.py``,
``_decode_kernel`` via ``fused_center_decode``). The kernel computes, per
crop in one pass, the chain of :func:`~unmore_tpu_torch.ops.fields.center_singularity_scores`
(union, three 9x9 erosions, 5x5 anti-center correlation, border, max and
first-occurrence argmax); see the note at the top of ``csrc/decode.cu``.

For a CPU tensor the wrapper runs that plain version; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from unmore_tpu_torch.ops.cuda_build import load_library
from unmore_tpu_torch.ops.fields import _anti_center_kernel, center_singularity_scores

MAX_SIZE = 256  # 3 x S*S bytes of shared memory must fit a block (227 KB)


def _load_library() -> ctypes.CDLL:
    lib = load_library("decode")
    fn = lib.unmore_fused_center_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.unmore_cuda_error_string.restype = ctypes.c_char_p
    lib.unmore_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=8)
def _device_weights(anti_k: int, device: torch.device) -> torch.Tensor:
    """[anti_k, anti_k, 2] f32 tap weights on ``device``, uploaded once."""
    return torch.from_numpy(_anti_center_kernel(anti_k)[..., 0].copy()).to(device)


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
    if erode_k < 1 or anti_k < 1 or erode_k % 2 == 0 or anti_k % 2 == 0:
        raise ValueError("erode_k and anti_k must be odd and positive")


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
    kernel on the current stream and count it in ``fused_center_decode.launches``.
    """
    _check(sdf_maps, center_fields, erode_k, anti_k)
    if sdf_maps.device.type == "cpu":
        return center_singularity_scores(
            sdf_maps, center_fields, border=border, erode_kernel=erode_k,
            erode_rounds=erode_rounds, anti_kernel=anti_k,
        )
    if sdf_maps.device.type != "cuda":
        raise ValueError(f"fused_center_decode runs on cpu or cuda, got {sdf_maps.device}")
    lib = _load_library()
    B, S, _ = sdf_maps.shape
    dev = sdf_maps.device
    weights = _device_weights(anti_k, dev)
    max_scores = torch.empty((B,), dtype=torch.float32, device=dev)
    argmax_yx = torch.empty((B, 2), dtype=torch.int32, device=dev)
    union = torch.empty((B, S, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.unmore_fused_center_decode(
            sdf_maps.data_ptr(), center_fields.data_ptr(), weights.data_ptr(),
            max_scores.data_ptr(), argmax_yx.data_ptr(), union.data_ptr(),
            B, S, border, erode_k, erode_rounds, anti_k, stream,
        )
    if err:
        raise RuntimeError(
            f"decode kernel launch failed: {lib.unmore_cuda_error_string(err).decode()} ({err})"
        )
    fused_center_decode.launches += 1
    return max_scores, argmax_yx, union


fused_center_decode.launches = 0
