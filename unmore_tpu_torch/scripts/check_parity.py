"""Activation parity of the port's models on the reference's own weights
(the port of ``scripts/parity/check_parity.py``).

    python -m unmore_tpu_torch.scripts.check_parity --npz reference_activations.npz \\
        --objectness_ckpt objectness_net_model.ckpt [--classifier_ckpt classifier_model.ckpt] [--device cpu]

``scripts/parity/dump_reference_activations.py`` runs the reference in its
own environment and writes the npz: the input crops, both heads' outputs,
the existence score and the taps ``scratch.layer{1..4}_rn`` and
``scratch.refinenet{1..4}``. This loads the same ``.ckpt`` files straight
into the port's models (they carry the reference's parameter names), runs
the dumped input through them in float32 with TF32 off in cuDNN and cuBLAS,
takes the same taps with forward hooks, and prints each tensor's max and
mean absolute difference from the dump in the dump's NCHW layout. The bar
is ``--tol`` of max abs difference (1e-3 for f32). Exit code 0 iff every
compared tensor passes (``PARITY OK``; else ``PARITY FAIL``). ``--tiny``
builds the miniature model of the harness's self-test
(``tests/torch_ref.py``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

TAPS = tuple(f"layer{n}_rn" for n in range(1, 5)) + tuple(f"refinenet{n}" for n in range(1, 5))


def build_objectness(args):
    from unmore_tpu_torch.models.objectness import ObjectnessNet
    from unmore_tpu_torch.models.vit import ViTConfig

    if args.tiny:
        return ObjectnessNet("dpt_base", "tanh", True, features=16, hooks=(0, 1, 2, 3), widths=(8, 16, 24, 24),
                             vit_config=ViTConfig(depth=4, dim=32, heads=2, mlp_dim=64, pretrain_grid=4))
    return ObjectnessNet(args.backbone_type, args.sdf_activation, args.use_bg_sdf)


def objectness_with_taps(model, x):
    """(the model's outputs, the scratch taps by name) on NHWC ``x``."""
    import torch

    taps, hooks = {}, []
    for name in TAPS:
        def keep(_module, _inputs, out, name=name):
            taps[name] = out.float().cpu().numpy()

        hooks.append(getattr(model.backbone.scratch, name).register_forward_hook(keep))
    try:
        with torch.no_grad():
            out = model(x)
    finally:
        for h in hooks:
            h.remove()
    return {k: v.cpu().numpy() for k, v in out.items()}, taps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--npz", required=True)
    ap.add_argument("--objectness_ckpt", required=True)
    ap.add_argument("--classifier_ckpt", default=None)
    ap.add_argument("--backbone_type", default="dpt_large")
    ap.add_argument("--sdf_activation", default="tanh")
    ap.add_argument("--use_bg_sdf", action="store_true", default=True)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--tiny", action="store_true", help="the miniature model of the harness self-test")
    ap.add_argument("--device", default=None, help="torch device (default: the card; cpu for runs on the CPU)")
    args = ap.parse_args(argv)

    import torch

    from unmore_tpu_torch.models.convert import load_objectness_state_dict, load_torch_checkpoint
    from unmore_tpu_torch.models.resnet import BinaryClassifier
    from unmore_tpu_torch.scripts.sticky_ab import setup_device

    device = setup_device(args.device)  # TF32 off: f32 means f32
    ref = np.load(args.npz)
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(ref["input"], (0, 2, 3, 1)))).to(device)
    model = build_objectness(args)
    load_objectness_state_dict(model, load_torch_checkpoint(args.objectness_ckpt))
    out, taps = objectness_with_taps(model.to(device, torch.float32).eval(), x)

    failures = []

    def compare(name, want, got):
        want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
        if want.shape != got.shape:
            print(f"  {name:16s} SHAPE MISMATCH ref{want.shape} vs ours{got.shape}")
            failures.append(name)
            return
        d = np.abs(want - got)
        status = "ok" if d.max() <= args.tol else "FAIL"
        if status == "FAIL":
            failures.append(name)
        print(f"  {name:16s} max|d|={d.max():.3e} mean|d|={d.mean():.3e} {status}")

    print(f"objectness parity (tol {args.tol}):")
    compare("center_fields", ref["center_fields"], np.transpose(out["center_fields"], (0, 3, 1, 2)))
    sdf = ref["sdf_maps"]
    compare("sdf_maps", sdf[:, 0] if sdf.ndim == 4 else sdf, out["sdf_maps"])
    for name in TAPS:
        if name in ref.files:
            compare(name, ref[name], taps[name])

    if args.classifier_ckpt and "existence" in ref.files:
        cls = BinaryClassifier()
        cls.load_state_dict(load_torch_checkpoint(args.classifier_ckpt), strict=True)
        with torch.no_grad():
            score = cls.to(device, torch.float32).eval()(x).cpu().numpy()
        print("classifier parity:")
        compare("existence", ref["existence"], score)

    if failures:
        print(f"PARITY FAIL: {failures}")
        return 1
    print("PARITY OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
