"""The Executor and the CLI in two processes over gloo on the CPU.

`retinanet_torch/tools/multiprocess_smoke.py` runs its checks: preemption
raised on one process mid-run and both checkpointing the same step, a
fresh resume, a sharded evaluation scored once on the chief with every val
image counted once, the same losses and parameters on both processes. Then
`python -m retinanet_torch --is_multi_host --device cpu` in two processes
with torchrun's environment runs `train_val` to its COCO record.
"""

import json
import multiprocessing
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.tools import multiprocess_smoke  # noqa: E402

WORLD = 2


def test_multiprocess_smoke(tmp_path):
    losses = multiprocess_smoke.run(tmp_path, procs=WORLD)
    assert all(np.isfinite(v) for v in losses.values()), losses
    assert losses["num-anchors-matched"] > 0


def _cli_rank(rank, port, argv, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from retinanet_torch import __main__ as cli
    result = cli.main(argv)
    with open(out, "w") as f:
        json.dump({"result": result}, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_multi_host_train_val(tmp_path):
    multiprocess_smoke.prepare(tmp_path)
    tree = json.loads((tmp_path / "config.json").read_text())
    tree["experiment"]["run_mode"] = "train_val"
    tree["training"].update(train_steps=2, log_every=1, save_every=2)
    config = tmp_path / "train_val.json"
    config.write_text(json.dumps(tree))
    argv = ["--config_path", str(config), "--device", "cpu",
            "--is_multi_host"]
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_cli_rank, args=(
        rank, port, argv, str(tmp_path / f"cli{rank}.json")))
        for rank in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(240)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0] * WORLD
    for rank in range(WORLD):
        assert json.loads((tmp_path / f"cli{rank}.json").read_text()) == {
            "result": True}
    model_dir = tmp_path / "models" / "mpexec"
    assert sorted(os.listdir(model_dir / "checkpoints")) == ["2.pt"]
    records = [json.loads(line) for line in
               (model_dir / "logs" / "train_metrics.jsonl").read_text()
               .splitlines()]
    # the chief alone writes: one record a step, one evaluation
    assert [r["step"] for r in records if "total-loss" in r] == [1, 2]
    evals = [r for r in records if "evaluation/AP-IoU=0.50" in r]
    assert [r["step"] for r in evals] == [2]
    assert (model_dir / "predictions.json").exists()
