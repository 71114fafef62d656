"""Weight-conversion CLI: TF1 checkpoints -> native .msgpack weights (port of
``semantic_depth_tpu/models/convert.py``), with no TensorFlow, flax or JAX.

Usage:
  python -m semantic_depth_tpu_torch.models.convert fcn \
      --checkpoint models/sem_seg/100-Epochs-roborace750/variables \
      --out models/sem_seg/100-Epochs-roborace750/fcn8s.msgpack

  python -m semantic_depth_tpu_torch.models.convert monodepth \
      --checkpoint models/monodepth/model_cityscapes/model_cityscapes \
      --encoder vgg --out models/monodepth/monodepth.msgpack

Covers the reference's published weight sets (the trained FCN-8s
checkpoints, the monodepth checkpoints and, through the FCN path, the
Udacity VGG16 variables). The checkpoint is read by ``tf_checkpoint`` and
checked strictly against the network's parameter shapes (built on the meta
device: no memory, no init); the file is the flax variable tree in float32,
which both packages' ``load_params`` read. ``--input_height`` and
``--input_width`` are kept for the JAX CLI's surface: the port's networks
need no input shape to know their parameters.
"""

from __future__ import annotations

import argparse

import torch

from . import FCN8s, Monodepth
from . import weights as W


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert TF1 checkpoints to native weights.")
    p.add_argument("model", choices=["fcn", "monodepth"])
    p.add_argument("--checkpoint", required=True,
                   help="TF checkpoint prefix or directory (its latest checkpoint)")
    p.add_argument("--out", required=True, help="output .msgpack path")
    p.add_argument("--encoder", default="vgg", help="monodepth encoder: vgg | resnet50")
    p.add_argument("--use_deconv", action="store_true",
                   help="checkpoint was trained with the transposed-conv decoder")
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--input_height", type=int, default=256)
    p.add_argument("--input_width", type=int, default=512)
    args = p.parse_args(argv)

    with torch.device("meta"):
        if args.model == "fcn":
            model = FCN8s(num_classes=args.num_classes)
        else:
            model = Monodepth(encoder=args.encoder, use_deconv=args.use_deconv)
    if args.model == "fcn":
        converted = W.convert_fcn_checkpoint(args.checkpoint)
    else:
        converted = W.convert_monodepth_checkpoint(
            args.checkpoint, encoder=args.encoder, use_deconv=args.use_deconv
        )

    params, _ = W.graft_tree(W.module_template(model), converted, strict=True)
    W.save_params(params, args.out)
    n = sum(leaf.size for layer in params["params"].values() for leaf in layer.values())
    print(f"wrote {args.out} ({n/1e6:.1f}M params)")


if __name__ == "__main__":
    main()
