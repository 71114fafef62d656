"""Export the fused frame program as a frozen serving program (port of
``semantic_depth_tpu/cli/export_pipeline.py``).

The reference ships ``optimized_graph.pb`` beside its SavedModel and loads
it with ``--use_frozen`` (semantic_depth.py:472-513). Here the whole fused
program (resize, both networks, the geometry with its kernels as dispatcher
ops) is written by ``torch.export`` with the weights inside (``export.py``);
``cli.semantic_depth --use_frozen <program>`` and ``cli.sequence
--use_frozen <program>`` serve from it without model code.

The program runs on the device it was exported on: export on the card that
serves (``--CUDA_DEVICE_NUMBER``), or with ``--device cpu`` for the CPU:

    python -m semantic_depth_tpu_torch.cli.export_pipeline \\
        --semantic_model w/fcn8s.msgpack --monodepth_checkpoint w/monodepth.msgpack \\
        --frame_height 1024 --frame_width 2048 --output pipeline.pt2
"""

from __future__ import annotations

import argparse

from . import common


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--semantic_model", type=str, required=True)
    p.add_argument("--monodepth_checkpoint", type=str, required=True)
    p.add_argument("--output", type=str, required=True, help="output .pt2 path")
    p.add_argument("--input_height", type=int, default=256,
                   help="pipeline grid height (network input)")
    p.add_argument("--input_width", type=int, default=512)
    p.add_argument("--frame_height", type=int, default=1024,
                   help="source frame height fixed in the program (it is "
                        "shape-specialised, like the reference's frozen graph)")
    p.add_argument("--frame_width", type=int, default=2048)
    p.add_argument("--batch", type=int, default=0,
                   help="export the BATCHED program for (batch, H, W, 3) inputs "
                        "(the streamed-sequence serving shape); 0 = single-frame")
    p.add_argument("--approach", type=str, default="both", choices=["rw", "both"])
    p.add_argument("--depth", type=float, default=10.0)
    p.add_argument("--is_city", action="store_true")
    p.add_argument("--full_outputs", action="store_true",
                   help="export every FrameOutputs field (masks, disparity, overlay, "
                        "clouds) so the artifact suite works when serving; the default "
                        "exports the distances only, without the dense stages")
    p.add_argument("--native_s2d", action="store_true")
    p.add_argument("--CUDA_DEVICE_NUMBER", default="0", help="the CUDA card to export on")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="'cpu' exports a program that runs on the CPU (tests)")
    p.add_argument("--dev_tiny", action="store_true", help=argparse.SUPPRESS)
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from ..config import cityscapes_pipeline_config, munich_pipeline_config
    from ..export import export_pipeline

    base = cityscapes_pipeline_config if args.is_city else munich_pipeline_config
    cfg = base(input_height=args.input_height, input_width=args.input_width,
               approach=args.approach, depth=args.depth)
    pipe = common.build_pipeline(
        cfg, args.semantic_model, args.monodepth_checkpoint,
        tiny=args.dev_tiny, native_s2d=args.native_s2d, device=common.cli_device(args))
    if args.batch:
        frame_shape = (args.batch, args.frame_height, args.frame_width, 3)
    else:
        frame_shape = (args.frame_height, args.frame_width, 3)
    path = export_pipeline(pipe, args.output, frame_shape=frame_shape,
                           batched=bool(args.batch), scalars_only=not args.full_outputs)
    print(f"Exported: {path}")
    return path


if __name__ == "__main__":
    main()
