"""The port's data-parallel step and train CLI with the full InceptionV3
over real gloo processes on the CPU (the twin model's cases, against the
JAX package, are test_torch_train_data_parallel.py's).

InceptionV3 at 75x75x7 runs in float64 (a float32 train step of this
network is ill-conditioned: float32 rounding moves its update by a few
percent, test_torch_train_inception.py): two steps of a batch of 8 with
accumulation 2 on 2 ranks against the one-rank float64 step, every leaf
to 1e-6 relative plus 1e-7 absolute (the head, as in the model, stays
float32, and its rounding reaches every gradient), the loss to 1e-9.

`torchrun --standalone --nproc_per_node=2 -m
deepvariant_tpu_torch.scripts.train ... --device cpu` trains on two
ranks; rank 0 alone writes the files."""

import os
import subprocess
import sys

import torch

from deepvariant_tpu.training.data import DatasetConfig
from deepvariant_tpu_torch.io import flax_msgpack
from deepvariant_tpu_torch.models import inception_v3 as iv3
from test_torch_train_data_parallel import (
    _assert_records_close,
    _batches,
    _fields,
    _files,
    _one_rank_records,
)
from torch_dist_util import PROCESS_TIMEOUT_S, REPO, run_ranks
from torch_port_util import random_flax_variables
from torch_train_util import write_training_records

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def test_inception_float64_two_ranks_match_one_rank(tmp_path):
    shape = (75, 75, 7)
    flax_vars = random_flax_variables(shape[2], seed=0)
    maps = {c: {k: v.numpy() for k, v in
                iv3.tree_from_flax(flax_vars[c]).items()}
            for c in ("params", "batch_stats")}
    batches = _batches(shape, n=8, seed=300)
    ranks = run_ranks("torch_dist_util:train_steps", 2, tmp_path,
                      cases=[_fields("sgd-ema-accum2")], variables=maps,
                      batches=batches, model="inception", dtype="float64")
    net = iv3.InceptionV3(shape[2], dropout_rate=0.0, dtype=torch.float64)
    tensors = {c: {k: torch.from_numpy(v.copy()).to(
        torch.float32 if k.startswith("classification") else torch.float64)
        for k, v in m.items()} for c, m in maps.items()}
    want = _one_rank_records("sgd-ema-accum2", net, tensors, batches)
    _assert_records_close(ranks[0][0], want, "inception float64",
                          loss_rtol=1e-9, rtol=1e-6, atol=1e-7)


def test_train_cli_under_torchrun(tmp_path):
    """`torchrun --standalone --nproc_per_node=2 -m
    deepvariant_tpu_torch.scripts.train ... --device cpu` trains the full
    InceptionV3 (75x75x7) on two ranks; rank 0 alone writes the files."""
    records = str(tmp_path / "train.tfrecord")
    write_training_records(records, 8, shape=(75, 75, 7), seed=4,
                           channels=[1] * 7)
    dataset = str(tmp_path / "train.pbtxt")
    DatasetConfig(name="train", tfrecord_path=records,
                  num_examples=8).write(dataset)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "deepvariant_tpu_torch.scripts.train",
         "--config", "wgs_test", "--train_dataset_config", dataset,
         "--tune_dataset_config", dataset, "--experiment_dir",
         str(tmp_path / "exp"), "--batch_size", "4", "--num_epochs", "1",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=PROCESS_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("train done") == 2
    assert _files(str(tmp_path / "exp")) == [
        "checkpoints/best.msgpack", "checkpoints/ckpt-0.msgpack",
        "checkpoints/example_info.json"]
    with open(str(tmp_path / "exp" / "checkpoints" / "ckpt-0.msgpack"),
              "rb") as f:
        state = flax_msgpack.unpack(f.read())
    assert int(state["step"]) == 2
