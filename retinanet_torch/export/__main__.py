"""Export CLI: `python -m retinanet_torch.export --config_path ... --export_dir
...` (counterpart of `retinanet_tpu/export/__main__.py`, the same flags with
`--exported` in place of `--stablehlo`, plus `--device`).

Writes the artifact directory of `export/serving.py` from the latest (or
`--checkpoint_step`) checkpoint of the config's model directory, seeded
random weights when there is none:
  * config.json, params.msgpack and, unless `--noexported`, the frozen
    serving graph serving_default.pt2;
  * `--int8`: params_int8.msgpack, the per-channel int8 weights
    (`export/quantize.py:quantize_params`);
  * `--int8_activations`: activation_scales.json (mode, calibration
    provenance, scales), calibrated on the config's val stream, or on the
    part of it that could be read, or on synthetic scenes (a provenance
    that says which); int8_activation_report.json; and, unless
    `--noexported`, the int8 serving graph serving_int8.pt2.
Runs on the CUDA card unless `--device cpu` asks for the CPU. Boolean flags
take `--flag`, `--noflag` and `--flag=true|false`. `main(argv)` can be
called in process.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import sys
from typing import Dict, List, Optional

import torch

from retinanet_torch.__main__ import _add_bool, _setup_logging

log = logging.getLogger("retinanet_torch.export")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m retinanet_torch.export",
        description="Write a serving artifact directory from a config and "
                    "its checkpoints.")
    parser.add_argument("--config_path", required=True,
                        help="Experiment config JSON")
    parser.add_argument("--export_dir", default="export",
                        help="Output artifact directory")
    parser.add_argument("--mode", default="tf",
                        help="tf | tf_tensorrt | onnx | onnx_tensorrt")
    parser.add_argument("--checkpoint_step", default=None,
                        help="Checkpoint step to export (default: latest)")
    parser.add_argument("--model_dir", default=None,
                        help="Model dir holding checkpoints")
    _add_bool(parser, "use_moving_average", False, "Export the EMA weights")
    _add_bool(parser, "int8", False, "Also write int8-quantized weights")
    _add_bool(parser, "int8_activations", False,
              "Calibrate per-tensor activation scales, report the quality "
              "of the int8-activation lane and serialize its graph")
    parser.add_argument("--calibration_mode", default="minmax",
                        help="minmax | percentile | entropy")
    _add_bool(parser, "require_real_calibration", False,
              "Fail the int8 activation calibration if the real val data "
              "stream is unavailable (instead of falling back to synthetic "
              "scenes)")
    parser.add_argument("--calibration_batches", type=int, default=4,
                        help="Calibration stream length (batches of 2)")
    _add_bool(parser, "exported", True,
              "Serialize the frozen torch.export serving graph")
    _add_bool(parser, "debug", False, "Verbose logging")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def calibration_batches(params, count: int, require_real: bool):
    """`count` image batches of 2 for calibration and their provenance: the
    config's val stream; the batches read before it failed; or, without
    any, synthetic scenes."""
    from retinanet_torch.data.pipeline import InputPipeline
    from retinanet_torch.data.synthetic import synthetic_train_batch

    h, w = (int(params.input.input_shape[0]),
            int(params.input.input_shape[1]))
    batches: List = []
    # provenance travels into activation_scales.json, so that a degraded
    # calibration shows in the artifact and not only in a log line
    provenance: Dict = {"source": "real", "requested_batches": int(count)}
    try:
        pipe = iter(InputPipeline("val", params, batch_size=2))
        for _ in range(count):
            batches.append(next(pipe)["image"])
        del pipe
    except Exception as e:  # noqa: BLE001 - missing or unreadable data
        if require_real:
            raise RuntimeError(
                "int8 activation calibration requires the real val "
                f"stream (--require_real_calibration) but it failed "
                f"after {len(batches)} batches: "
                f"{type(e).__name__}: {e}") from e
        provenance["error"] = f"{type(e).__name__}: {e}"
        if batches:
            # partial real data beats synthetic scenes
            provenance["source"] = "partial_real"
            log.warning("val stream failed after %d batches (%s: %s); "
                        "calibrating on the real batches read so far",
                        len(batches), type(e).__name__, e)
        else:
            provenance["source"] = "synthetic"
            log.warning("val tfrecords unavailable (%s: %s); calibrating on "
                        "synthetic scenes", type(e).__name__, e)
            batches = [
                synthetic_train_batch(
                    2, (h, w), 20,
                    int(params.architecture.head.num_classes),
                    seed=i)["image"]
                for i in range(count)]
    else:
        log.info("calibrating on %d real val batches", len(batches))
    provenance["used_batches"] = len(batches)
    return batches, provenance


def main(argv: Optional[List[str]] = None) -> Dict[str, str]:
    """Parse `argv` and write the artifact; returns {artifact: path}."""
    args = build_parser().parse_args(argv)
    from retinanet_torch.convert import torch_to_flax
    from retinanet_torch.core.config import Config
    from retinanet_torch.export import msgpack_codec
    from retinanet_torch.export import serving as serving_lib
    from retinanet_torch.train.executor import Executor

    _setup_logging(args.debug, "")
    params = Config(args.config_path).params
    executor = Executor(params, run_mode="export", model_dir=args.model_dir,
                        resume_from=args.checkpoint_step, device=args.device)
    try:
        if executor.latest_checkpoint_step() is None:
            log.warning("No checkpoint found in %s — exporting randomly "
                        "initialized weights", executor.model_dir)
        model = executor.model.eval()
        if args.use_moving_average and executor.state.ema_params is not None:
            log.info("Exporting EMA weights")
            model = copy.deepcopy(model)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(executor.state.ema_params[name])

        written = serving_lib.export_artifact(
            params, model, args.export_dir, mode=args.mode,
            serialize_graph=args.exported)
        for k, v in written.items():
            log.info("Wrote %s: %s", k, v)

        if args.int8:
            from retinanet_torch.export.quantize import quantize_params
            qparams, stats = quantize_params(
                torch_to_flax(model.state_dict())["params"])
            path = os.path.join(args.export_dir, "params_int8.msgpack")
            msgpack_codec.write_file(path, qparams)
            written["int8_weights"] = path
            log.info("Wrote int8 weights: %s (compression %.2fx)", path,
                     stats["bytes_fp32"] / max(stats["bytes_q"], 1))

        if args.int8_activations:
            written.update(_int8_activations(args, params, executor, model))
        return written
    finally:
        executor.close()


def _int8_activations(args, params, executor, model) -> Dict[str, str]:
    from retinanet_torch.export import serving as serving_lib
    from retinanet_torch.export.calibration import calibrate_activations
    from retinanet_torch.export.quantize import int8_activation_report

    written = {}
    batches, provenance = calibration_batches(
        params, args.calibration_batches, args.require_real_calibration)
    scales = calibrate_activations(
        model, batches, mode=args.calibration_mode,
        preprocess=lambda im: executor.normalizer(im).to(
            executor.compute_dtype))
    spath = os.path.join(args.export_dir, serving_lib.SCALES_FILE)
    with open(spath, "w") as f:
        json.dump({"mode": args.calibration_mode,
                   "calibration": provenance, "scales": scales}, f,
                  indent=1)
    written["activation_scales"] = spath
    report = int8_activation_report(model, params, scales, batches)
    rpath = os.path.join(args.export_dir, "int8_activation_report.json")
    with open(rpath, "w") as f:
        json.dump(report, f, indent=1)
    written["int8_activation_report"] = rpath
    log.info("int8 activation calibration (%s): %s -> %s",
             args.calibration_mode, report, rpath)
    if args.exported:
        # the self-contained int8 program: `evaluate_artifact
        # --use_exported --use_int8_activations` runs it
        written["int8_graph"] = serving_lib.serialize_serving_graph(
            params, model, args.export_dir, mode=args.mode,
            int8_scales=scales)
        log.info("Wrote int8 serving graph: %s", written["int8_graph"])
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
