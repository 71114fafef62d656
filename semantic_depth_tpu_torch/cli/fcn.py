"""FCN-8s train/test entry point (port of ``semantic_depth_tpu/cli/fcn.py``;
reference fcn8s/fcn.py:601-680).

Train mode: epochs over a Cityscapes-layout dataset with the reference
augmentations and hyperparameters, per-epoch loss/IoU CSV logs, then
``fcn8s.msgpack`` (the weight file the inference CLIs of both packages
read) and a step checkpoint under ``<model_dir>/<model>/checkpoints``.

Test mode: loads ``<model_dir>/<model>/fcn8s.msgpack``, or the reference's
TF1 SavedModel variables under ``<model_dir>/<model>/variables`` (read and
converted without TensorFlow), computes the test-set mean IoU, writes
per-image overlay PNGs under runs/<model>/<timestamp>/, ``times.txt`` and
the IoU log under log/<model>/iou/ (FCN.inference, fcn.py:384-492).

Runs on the card (``--CUDA_DEVICE_NUMBER`` picks it) unless ``--device cpu``:

    python -m semantic_depth_tpu_torch.cli.fcn --mode train --epochs 100 \\
        --dataset roborace750 --data_dir data

``--init_from`` warm-starts training from a .msgpack file, a full FCN-8s
TF1 checkpoint, or the encoder-only VGG16 one (the reference's ``load_vgg``
start: the decoder keeps its trunc-normal init).

``--mesh`` trains data/tensor-parallel (``parallel/train_step.py``) over the
ranks torchrun launched, one process per mesh position, on the default
``make_mesh()`` (tp=2 when the rank count is even): every rank reads the
same seeded batches and takes its slice, and rank 0 alone prints and writes
the logs, the overlays, ``fcn8s.msgpack`` and the checkpoint:

    torchrun --nproc_per_node 2 -m semantic_depth_tpu_torch.cli.fcn --mesh \\
        --mode train --epochs 100 --batch_size 8 --dataset roborace750 --data_dir data
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import torch

from ..config import TrainConfig
from ..models import FCN8s
from ..models import weights as weights_lib
from ..ops.overlay import segmentation_overlay
from ..train.data import SegmentationDataset, get_files_paths
from ..train.metrics import MeanIoU
from ..train.trainer import FCNTrainer
from . import common


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FCN-8s implementation (PyTorch/CUDA port).")
    p.add_argument("--mode", type=str, default="train", help="train or test")
    p.add_argument("--epochs", type=int, help="number of training epochs")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--inference_flag", action="store_true")
    p.add_argument("--learning_rate", type=float, default=0.00001)
    p.add_argument("--dropout", type=float, default=0.5,
                   help="keep probability (reference semantics)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--image_shape", default=(256, 512))
    p.add_argument("--runs_dir", type=str, default="runs")
    p.add_argument("--data_dir", type=str, default="../data")
    p.add_argument("--train_gt_subdir", type=str, default="gtFine/train")
    p.add_argument("--train_imgs_subdir", type=str, default="leftImg8bit/train")
    p.add_argument("--val_gt_subdir", type=str, default="gtFine/val")
    p.add_argument("--val_imgs_subdir", type=str, default="leftImg8bit/val")
    p.add_argument("--test_gt_subdir", type=str, default="gtFine/test")
    p.add_argument("--test_imgs_subdir", type=str, default="leftImg8bit/test")
    p.add_argument("--model_dir", type=str, default="../models/sem_seg")
    p.add_argument("--logging_dir", type=str, default="log")
    p.add_argument("--model", type=str, default=None,
                   help="model name for test mode ('<epochs>-Epochs-<dataset>'); "
                        "read interactively if omitted (reference fcn.py:666-668)")
    p.add_argument("--mesh", action="store_true",
                   help="train data/tensor-parallel over the ranks torchrun launched")
    p.add_argument("--init_from", type=str, default=None,
                   help="warm-start training from a .msgpack weight file (or a directory "
                        "holding fcn8s.msgpack), a full FCN-8s TF1 checkpoint, or an "
                        "encoder-only VGG16 checkpoint (decoder keeps its init)")
    p.add_argument("--CUDA_DEVICE_NUMBER", default="0", help="the CUDA card to run on")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="'cpu' runs the plain PyTorch path on the CPU (tests)")
    p.add_argument("--dev_tiny", action="store_true", help=argparse.SUPPRESS)
    return p


def _image_shape(args):
    shape = args.image_shape
    if isinstance(shape, str):
        shape = tuple(int(x) for x in shape.strip("()").split(","))
    return shape


def make_dataset(args) -> SegmentationDataset:
    return SegmentationDataset(
        args.data_dir,
        args.dataset,
        image_shape=_image_shape(args),
        train_gt_subdir=args.train_gt_subdir,
        train_imgs_subdir=args.train_imgs_subdir,
        val_gt_subdir=args.val_gt_subdir,
        val_imgs_subdir=args.val_imgs_subdir,
        test_gt_subdir=args.test_gt_subdir,
        test_imgs_subdir=args.test_imgs_subdir,
    )


def load_weights(trainer: FCNTrainer, path: str) -> None:
    """Test mode's weights, by ``common.load_fcn_params``' rules: a .msgpack
    file, a directory holding fcn8s.msgpack, or the directory's TF1
    checkpoint (``<path>/variables`` or ``path``), converted strictly."""
    trainer.set_params(common.fcn_params(path, trainer.params_tree()))


def load_warm_start(trainer: FCNTrainer, path: str) -> None:
    """Resolve --init_from: a .msgpack file (or a directory holding
    fcn8s.msgpack), a full FCN-8s TF1 checkpoint (VGG and decoder, fcn.py's
    save_model layout), or an encoder-only VGG16 checkpoint, whose decoder
    then keeps the trainer's trunc-normal init, as the reference's load_vgg
    warm start does (fcn8s/fcn.py:82-95). A directory means its latest
    checkpoint (``<path>/variables`` first)."""
    native = common.fcn_weights_file(path)
    if native is not None:
        trainer.set_params(weights_lib.load_params(native))
        return
    ckpt = common.fcn_checkpoint(path) if os.path.isdir(path) else path
    if ckpt is None:
        raise FileNotFoundError(f"no TF checkpoint found under {path}")
    template = trainer.params_tree()
    try:
        converted = weights_lib.convert_fcn_checkpoint(ckpt)
        params, _ = weights_lib.graft_tree(template, converted, strict=True)
    except KeyError:
        # no decoder variables -> encoder-only VGG16 checkpoint
        converted = weights_lib.convert_vgg_checkpoint(ckpt)
        params, loaded = weights_lib.graft_tree(template, converted)
        if common.is_writer():
            print(f"Warm start: loaded {len(loaded)} encoder layers from {ckpt}; "
                  "decoder keeps trunc-normal init")
    trainer.set_params(params)


def make_trainer(args, device=None, mesh=None) -> FCNTrainer:
    cfg = TrainConfig(
        learning_rate=args.learning_rate,
        dropout=args.dropout,
        batch_size=int(args.batch_size),
        num_classes=args.num_classes,
        epochs=args.epochs or 1,
        image_shape=_image_shape(args),
    )
    model = None
    if args.dev_tiny:
        model = FCN8s(num_classes=cfg.num_classes, dropout_keep_prob=cfg.dropout,
                      width_mult=0.125, fc_channels=32,
                      generator=torch.Generator().manual_seed(0))
    trainer = FCNTrainer(cfg, model=model, device=device or common.cli_device(args), mesh=mesh)
    if args.init_from:
        load_warm_start(trainer, args.init_from)
    return trainer


def run_inference(trainer: FCNTrainer, dataset: SegmentationDataset, args, model_name: str):
    """Test-set IoU + overlay PNGs + times.txt (fcn.py:384-492). Under a
    mesh every rank evaluates, and rank 0 alone writes and prints."""
    writer = common.is_writer()
    time_str = datetime.now()
    time_str = "{}_{}_{} {}-{}".format(
        time_str.year, time_str.month, time_str.day, time_str.hour, time_str.minute
    )
    output_dir = os.path.join(args.runs_dir, model_name, time_str)
    if writer:
        os.makedirs(output_dir, exist_ok=True)

    gt_dir, imgs_dir = dataset.dirs["test"]
    _, imgs_paths = get_files_paths(gt_dir, imgs_dir)

    miou = MeanIoU(args.num_classes)
    per_image = []
    times = []
    for (images, labels), image_file in zip(dataset.batches(1, mode="test"), imgs_paths):
        t0 = time.time()
        m = trainer.eval_batch(images, labels)
        miou.cm = miou.cm + torch.from_numpy(m["cm"])
        per_image.append(miou.result())  # running IoU, like the streaming metric
        t1 = time.time() - t0
        if not writer:
            continue
        probs = torch.from_numpy(m["probs"][0])
        overlay = segmentation_overlay(
            torch.from_numpy(images[0]), probs[:, :, 0] > 0.5, probs[:, :, 1] > 0.5,
            (128, 64, 128, 64), (190, 153, 153, 64),  # fcn.py:450,457
        ).numpy()
        t2 = time.time() - t0
        times.append(f"{t1} {t2}\n")
        out_path = os.path.join(output_dir, os.path.basename(image_file))
        common.imwrite(out_path, overlay[:, :, ::-1])  # RGB -> BGR for the writer

    test_mean_iou = miou.result()
    if not writer:
        return test_mean_iou
    with open("times.txt", "w") as f:
        for pair in times:
            f.write(pair)

    print("TEST: mean iou of test set: {}".format(test_mean_iou))
    metric_path = os.path.join(args.logging_dir, model_name, "iou")
    os.makedirs(metric_path, exist_ok=True)
    with open(os.path.join(metric_path, f"test_set_iou_{time_str}.txt"), "w") as f:
        for iou in per_image:
            f.write(f"{iou}\n")
        f.write(f"IoU metric of Testing set: {test_mean_iou}")
    return test_mean_iou


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    if args.mode == "train":
        if args.epochs is None:
            raise SystemExit("train mode requires --epochs.")
        model_name = f"{args.epochs}-Epochs-{args.dataset}"
    elif args.mode == "test":
        model_name = args.model
        while not model_name:
            model_name = input(
                "Enter the name of the model you want to use in the format "
                "'<epochs>-Epochs-<dataset>' \n--> "
            )
    else:
        raise SystemExit(f"unknown mode {args.mode}")

    device, own_group, mesh = None, False, None
    if args.mesh:
        from ..parallel import make_mesh

        device, own_group = common.join_mesh(args)
        mesh = make_mesh()  # dp x tp over every rank
    writer = common.is_writer()
    dataset = make_dataset(args)
    trainer = make_trainer(args, device, mesh)
    model_var_dir = os.path.join(args.model_dir, model_name)

    if args.mode == "train":
        trainer.fit(dataset, log_dir=args.logging_dir if writer else None,
                    model_name=model_name, verbose=writer)
        if args.inference_flag:
            run_inference(trainer, dataset, args, model_name)
        if writer:
            os.makedirs(model_var_dir, exist_ok=True)
        trainer.save_msgpack(os.path.join(model_var_dir, "fcn8s.msgpack"))
        trainer.save_checkpoint(os.path.join(model_var_dir, "checkpoints"))
        if writer:
            print(f"Saving model to: {model_var_dir}")
    else:
        load_weights(trainer, model_var_dir)
        run_inference(trainer, dataset, args, model_name)
    common.leave_mesh(own_group)


if __name__ == "__main__":
    main()
