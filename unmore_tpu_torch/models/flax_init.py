"""flax's parameter initialisation in torch: from one seed, the weights that
the JAX package's ``model.init(jax.random.PRNGKey(seed), ...)`` gives, leaf
for leaf, for the objectness net (``dpt_large``, ``dpt_base``,
``dpt_hybrid``), the ResNet-50 classifier and the Cascade Mask R-CNN.

flax gives every parameter its own key: ``fold_in(root, h)``, where ``h`` is
the first 4 bytes (big-endian) of the SHA-1 of the names of the parameter's
scopes (the modules on its path, without the collection and the leaf name),
followed by the scope's count of ``params`` draws so far, as its shortest
big-endian bytes (``flax/core/scope.py`` ``_fold_in_static``). Within a
scope the count is the leaf's place in creation order, from 1: ``kernel``
before ``bias``, ``scale`` before ``bias``, ``cls_token`` before
``pos_embed``; a submodule's draws do not count in its parent.

The draws are the defaults that the JAX package's modules declare:

* ``kernel``: lecun normal, ``variance_scaling(1, "fan_in",
  "truncated_normal")``: a normal truncated to (-2, 2) times
  ``sqrt(1 / fan_in) / 0.8796...`` (both float32), with flax's fans on
  flax's shape (``shape[-2]`` times the receptive field, for Dense, Conv
  and ConvTranspose alike);
* ``pos_embed``: normal times 0.02;
* ``bias`` and ``cls_token`` zero, ``scale`` one; BatchNorm statistics mean
  0 and var 1.

Leaves are drawn in flax's layout and shape on the model's device, then
carried into the model by the package's converters (``models/convert.py``,
``detector/convert.py``), which own every transpose. Leaves that the JAX
tree lacks (refinenet4's ``resConfUnit1``, ``num_batches_tracked``) are
zero. On a card a large leaf is drawn in pieces: a piece's elements are
their own counters of the leaf's one stream, so the pieces join into the
whole draw. On the CPU the host library ``csrc/flax_init.cpp`` draws (the
torch ops take ~0.7 us an element there, minutes for DPT-Large).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math

import numpy as np
import torch

from unmore_tpu_torch.detector import convert as detector_convert
from unmore_tpu_torch.detector.cascade_rcnn import CascadeMaskRCNN
from unmore_tpu_torch.models import convert
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.ops.cuda_build import load_library
from unmore_tpu_torch.utils import prng

TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to (-2, 2)
POS_EMBED_STD = 0.02
# creation order within a flax scope: a leaf's count is 1 + the leaves of its
# scope that come before it
_ORDER = {"kernel": 0, "scale": 0, "cls_token": 0, "bias": 1, "pos_embed": 1}
_CONSTANT = {"bias": 0.0, "scale": 1.0, "cls_token": 0.0, "mean": 0.0, "var": 1.0}
# elements of one piece of a draw on a card: it holds ~10 int64 / float64
# temporaries of this length (~2.7 GB)
PIECE = 1 << 25


def leaf_hash(scopes, count: int) -> int:
    """flax's ``_fold_in_static`` data for the ``count``-th draw in the scope
    ``scopes`` (module names from the root)."""
    m = hashlib.sha1()
    for name in scopes:
        m.update(name.encode("utf-8"))
    m.update(count.to_bytes((count.bit_length() + 7) // 8, "big"))
    return int.from_bytes(m.digest()[:4], "big")


def draw_counts(paths) -> dict[tuple, int]:
    """The ``params`` count of each leaf path (scope names + leaf name) in
    its scope, from creation order."""
    siblings: dict[tuple, list[str]] = {}
    for path in paths:
        siblings.setdefault(tuple(path[:-1]), []).append(path[-1])
    return {tuple(p): 1 + sum(_ORDER[s] < _ORDER[p[-1]] for s in siblings[tuple(p[:-1])]) for p in paths}


def lecun_stddev(shape) -> float:
    """The float32 stddev of flax's ``lecun_normal`` for a kernel of flax
    ``shape``, rounded as ``jax.nn.initializers.variance_scaling`` rounds it."""
    receptive = math.prod(shape) / shape[-2] / shape[-1]
    variance = np.float32(1.0 / (shape[-2] * receptive))
    return float(np.sqrt(variance) / np.float32(TRUNC_STD))


@functools.lru_cache(maxsize=None)
def _host_library() -> ctypes.CDLL:
    lib = load_library("flax_init")
    lib.flax_draw.restype = None
    lib.flax_draw.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
                              ctypes.c_void_p, ctypes.c_int32]
    return lib


def _draw(key, shape, kind: str, device: torch.device) -> torch.Tensor:
    """One random leaf of flax ``shape``, float32 on ``device``: ``kind``
    "kernel" (lecun normal) or "pos_embed" (normal times 0.02). On the CPU
    the host library ``csrc/flax_init.cpp`` computes the draw's float32 steps
    element by element, over torch's thread count; on a card the torch ops of
    :mod:`~unmore_tpu_torch.utils.prng` run in pieces of :data:`PIECE`."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    if device.type == "cpu":
        k1, k2 = (int(w) for w in key)
        scale = lecun_stddev(shape) if kind == "kernel" else prng.normal_scale(POS_EMBED_STD)
        _host_library().flax_draw(k1, k2, n, 0 if kind == "kernel" else 1, scale, out.data_ptr(),
                                  torch.get_num_threads())
        return out.view(shape)
    for start in range(0, n, PIECE):
        m = min(PIECE, n - start)
        if kind == "kernel":
            out[start:start + m] = prng.truncated_normal(key, -2, 2, m, start, device) * lecun_stddev(shape)
        else:
            out[start:start + m] = prng.normal(key, m, start, device, scale=POS_EMBED_STD)
    return out.view(shape)


def _family(model: torch.nn.Module, sd):
    """(layout, to_port) of ``model``: for each state-dict key that the JAX
    tree holds, its path there (collection first) and layout rule; and the
    converter of a JAX tree of tensors into the port's tensors by key."""
    if isinstance(model, ObjectnessNet):  # its JAX tree is the params collection alone
        params = convert.flax_layout(sd, "objectness")
        layout = {k: (("params", *path), kind) for k, (path, kind) in params.items()}
        return layout, lambda tree: convert.tensors_from_flax(tree["params"], params)
    if isinstance(model, BinaryClassifier):
        layout = convert.flax_layout(sd, "classifier")
        return layout, lambda tree: convert.tensors_from_flax(tree, layout)
    if isinstance(model, CascadeMaskRCNN):
        return detector_convert.flax_layout(sd), detector_convert.state_dict_from_flax
    raise TypeError(f"no flax initialisation for {type(model).__name__}")


@torch.no_grad()
def init_like_flax(model: torch.nn.Module, seed: int):
    """Fill ``model`` with the weights of the JAX package's flax init from
    ``jax.random.PRNGKey(seed)``, drawn on the model's device."""
    sd = model.state_dict()
    device = next(iter(sd.values())).device
    layout, to_port = _family(model, sd)
    paths = {k: path for k, (path, _) in layout.items() if path[0] == "params"}
    counts = draw_counts([p[1:] for p in paths.values()])
    drawn = [k for k, path in paths.items() if path[-1] in ("kernel", "pos_embed")]
    hashes = [leaf_hash(paths[k][1:-1], counts[paths[k][1:]]) for k in drawn]
    keys = dict(zip(drawn, prng.fold_in(prng.prng_key(seed), torch.tensor(hashes, dtype=torch.int64))))
    tree: dict = {}
    for k, (path, kind) in layout.items():
        shape = convert.flax_shape(sd[k].shape, kind)
        if k in keys:
            leaf = _draw(keys[k], shape, path[-1], device)
        else:
            leaf = torch.full(shape, _CONSTANT[path[-1]], dtype=torch.float32, device=device)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    values = to_port(tree)
    for k, t in sd.items():
        if k in values:
            t.copy_(values[k])
        else:
            t.zero_()
