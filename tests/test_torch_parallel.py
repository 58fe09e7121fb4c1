"""The port's scale-out primitives (deepvariant_tpu_torch.parallel.
distribute) and its Predictors over several devices, against the JAX
package's on the 8-device CPU mesh of tests/conftest.py.

The collectives run in real processes that form a gloo group through a
file store (torch_dist_util.run_ranks). Counts and layouts are exact;
the prefetch and fused pipelines move the same numbers (exact); the
Predictors' probabilities agree with the JAX Predictor's to 1e-5 (float32
in both, the conv sums in another order), and a port Predictor over
several devices with its one-device self to 1e-6."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvariant_tpu.calling import call_variants as jax_cv
from deepvariant_tpu.parallel import distribute as jax_dist
from deepvariant_tpu_torch.calling import call_variants as cv
from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
from deepvariant_tpu_torch.make_examples.pileup import PileupOptions
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.parallel import distribute
from torch_dist_util import REPO, TESTS, run_ranks
from torch_port_util import random_flax_variables, random_plans
from torch_train_util import (TWIN_SHAPE, JaxTwin, TorchTwin,
                              twin_variables)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("n,pid", [(1, 0), (2, 1), (3, 2), (4, 0), (7, 5)])
def test_host_shard_assignment_matches_jax(n, pid):
    for items in (0, 5, 10, 23):
        assert distribute.host_shard_assignment(items, pid, n) == \
            jax_dist.host_shard_assignment(items, pid, n)
    # Without a group, one process holds every item, as JAX's one
    # process does.
    assert distribute.host_shard_assignment(6) == \
        jax_dist.host_shard_assignment(6) == list(range(6))


@pytest.mark.parametrize("world", [2, 4])
def test_all_gather_counts_over_gloo_ranks_matches_jax(tmp_path, world):
    ranks = run_ranks("torch_dist_util:gather_counts", world, tmp_path)
    local = np.array([10 + 3 * r for r in range(world)], np.int32)
    want = jax_dist.all_gather_counts(
        local, jax_dist.data_parallel_mesh(jax.devices()[:world]))
    with pytest.raises(ValueError, match="one count per mesh position"):
        jax_dist.all_gather_counts(list(range(world + 1)),
                                   jax_dist.data_parallel_mesh(
                                       jax.devices()[:world]))
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got["counts"], want)
        assert "one count per mesh position" in got["error"]
        assert got["mesh"] == (world, rank, "gloo")
        assert got["shard"] == jax_dist.host_shard_assignment(10, rank,
                                                              world)


def test_all_gather_counts_in_one_process():
    mesh = distribute.data_parallel_mesh("cpu")
    assert not mesh.grouped and (mesh.world_size, mesh.rank) == (1, 0)
    np.testing.assert_array_equal(distribute.all_gather_counts(7, mesh),
                                  [7])
    np.testing.assert_array_equal(distribute.all_gather_counts([9], mesh),
                                  [9])
    with pytest.raises(ValueError, match="one count per mesh position"):
        distribute.all_gather_counts([1, 2], mesh)


def test_initialize_multihost_paths(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    # No arguments and no torchrun variables: one process, no group.
    assert distribute.initialize_multihost(device="cpu") == (0, 1)
    assert distribute.initialize_multihost(num_processes=1,
                                           device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        distribute.initialize_multihost(num_processes=2, device="cpu")
    assert distribute.choose_backend(torch.device("cpu"), 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distribute.choose_backend(torch.device("cuda"), 2) == "nccl"
    # Ranks sharing a card meet over gloo.
    assert distribute.choose_backend(torch.device("cuda"), 3) == "gloo"


def test_initialize_multihost_reads_torchrun_variables():
    """A torchrun-style world of one: RANK, WORLD_SIZE and the master
    address from the environment (port 0: the store picks a free one)."""
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="0",
               PYTHONPATH=os.pathsep.join([REPO, TESTS]))
    code = (
        "from deepvariant_tpu_torch.parallel import distribute as d\n"
        "import torch.distributed as dist\n"
        "print(d.initialize_multihost(device='cpu', timeout_s=30),"
        " dist.get_backend(), d.data_parallel_mesh('cpu').grouped)\n"
        "d.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["(0,", "1)", "gloo", "True"]


def test_shardings_replicate_state_and_cut_the_batch():
    mesh = distribute.DataParallel(world_size=2, rank=1, backend="gloo")
    replicated, data = distribute.shardings(mesh)
    state = {"w": np.ones(3)}
    assert replicated(state) is state
    np.testing.assert_array_equal(data({"x": np.arange(8)})["x"],
                                  [4, 5, 6, 7])


def test_micro_batch_layout_by_hand():
    """Accumulation 2 over 4 ranks of a batch of 16: micro batch 0 is
    rows 0-7, micro batch 1 rows 8-15, each cut in parts of 2."""
    want = {0: [0, 1, 8, 9], 1: [2, 3, 10, 11], 2: [4, 5, 12, 13],
            3: [6, 7, 14, 15]}
    for rank, rows in want.items():
        layout = distribute.DataParallel(world_size=4, rank=rank,
                                         backend="gloo")
        assert layout.local_rows(16, accum=2).tolist() == rows
        batch = {"x": np.arange(16) * 10}
        assert layout.local_batch(batch, accum=2)["x"].tolist() == [
            10 * r for r in rows]
    assert distribute.DataParallel(world_size=2, rank=1, backend="gloo") \
        .local_rows(6).tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="does not split"):
        distribute.DataParallel(world_size=4, rank=0, backend="gloo") \
            .local_rows(12, accum=2)
    batch = {"x": np.arange(5)}
    assert distribute.DataParallel().local_batch(batch, accum=2) is batch


def test_device_prefetch_iterator_order_and_error():
    batches = [np.full((4,), i, np.float32) for i in range(5)]
    want = [np.asarray(b) for b in
            jax_dist.DevicePrefetchIterator(iter(batches))]
    out = list(distribute.DevicePrefetchIterator(iter(batches), "cpu"))
    assert len(out) == len(want) == 5
    for got, w in zip(out, want):
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), w)
    dicts = list(distribute.DevicePrefetchIterator(
        iter([{"a": b, "b": b * 2} for b in batches]), "cpu"))
    for i, item in enumerate(dicts):
        np.testing.assert_array_equal(item["b"].numpy(), 2.0 * i)

    def failing():
        yield np.zeros(2)
        raise RuntimeError("boom")

    it = distribute.DevicePrefetchIterator(failing(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_fused_encode_infer_matches_jax():
    mesh = jax_dist.data_parallel_mesh(jax.devices()[:8])
    replicated, _ = jax_dist.shardings(mesh)
    jax_vars = jax.device_put({"w": jnp.asarray([2.0, -1.5, 0.25])},
                              replicated)
    batches = [np.random.RandomState(i).randint(0, 255, (8, 3), np.uint8)
               for i in range(6)]
    want = list(jax_dist.fused_encode_infer(
        iter(batches), jax.jit(lambda v, b: b.astype(jnp.float32) * v["w"]),
        jax_vars, mesh=mesh))
    calls = []

    def forward(variables, batch):
        calls.append(batch.shape)
        return batch.to(torch.float32) * variables["w"]

    got = list(distribute.fused_encode_infer(
        iter(batches), forward, {"w": torch.tensor([2.0, -1.5, 0.25])},
        device="cpu", prefetch=2))
    assert len(got) == len(want) == 6 and calls == [(8, 3)] * 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _twin_images(n, seed):
    return np.random.RandomState(seed).randint(
        0, 255, (n,) + TWIN_SHAPE, np.uint8)


def test_predictor_on_eight_devices_rounds_and_matches_jax():
    """Batch 12 over 8 devices becomes 8 in both packages; 19 examples go
    through in 3 batches, the last padded."""
    variables = twin_variables(4)
    jax_pred = jax_cv.Predictor(
        jax.tree_util.tree_map(jnp.asarray, variables), batch_size=12,
        model=JaxTwin(), devices=jax.devices()[:8])
    model = TorchTwin()
    model.load_state_dict({**iv3.tree_from_flax(variables["params"]),
                           **iv3.tree_from_flax(variables["batch_stats"])})
    port = cv.Predictor(model, batch_size=12, device="cpu",
                        dtype=torch.float32, devices=["cpu"] * 8)
    assert port.batch_size == jax_pred.batch_size == 8
    assert len(port.replicas) == 8
    assert cv.Predictor(model, 3, "cpu", torch.float32,
                        devices=["cpu"] * 8).batch_size == 8
    images = _twin_images(19, 1)
    records = [cv.ExampleRecord(image=img, variant=None,
                                alt_allele_indices=[0]) for img in images]
    want = np.stack([p for _, p in jax_pred.predict_stream(
        iter([jax_cv.ExampleRecord(image=r.image, variant=None,
                                   alt_allele_indices=[0])
              for r in records]))])
    pairs = list(port.predict_stream(iter(records)))
    assert [r for r, _ in pairs] == records
    got = np.stack([p for _, p in pairs])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port(images[:5]), want[:5], rtol=1e-5,
                               atol=1e-5)


def test_inception_predictors_over_devices_match_one_device():
    """The full InceptionV3 Predictor and PlanPredictor over 4 CPU
    devices against their one-device selves."""
    variables = random_flax_variables(7, seed=3)
    model = iv3.InceptionV3(7)
    model.load_state_dict(iv3.from_flax_variables(variables))
    images = np.random.RandomState(2).randint(0, 255, (6, 100, 221, 7),
                                              np.uint8)
    one = cv.Predictor(model, 4, "cpu", torch.float32)
    four = cv.Predictor(model, 6, "cpu", torch.float32,
                        devices=["cpu"] * 4)
    assert (one.batch_size, four.batch_size) == (4, 4)
    want = np.concatenate([one(images[:4]), one(images[4:])])
    got = np.concatenate([four(images[:4]), four(images[4:])])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    plans = random_plans(5, seed=8)
    plans = [{k: v[i] for k, v in plans.items()} for i in range(5)]
    plan_one = PlanPredictor(model, PileupOptions(), batch_size=2,
                             device="cpu", dtype=torch.float32)
    plan_two = PlanPredictor(model, PileupOptions(), batch_size=3,
                             device="cpu", dtype=torch.float32,
                             devices=["cpu", "cpu"])
    assert plan_two.batch_size == 2
    np.testing.assert_array_equal(plan_one.encode(plans[:2]).numpy(),
                                  plan_two.encode(plans[:2]).numpy())
    want = np.stack([p for _, p in plan_one.predict_plan_stream(
        iter([type("P", (), {"plan": p}) for p in plans]))])
    got = np.stack([p for _, p in plan_two.predict_plan_stream(
        iter([type("P", (), {"plan": p}) for p in plans]))])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
