"""Running a function in several real processes that form a gloo group
on the CPU, for the tests of the port's data parallelism.

`run_ranks("module:function", n, tmp_path, **kwargs)` starts n Python
processes; each joins the group through a `file://` store under
`tmp_path` (no TCP port, so parallel test workers never race for one)
with `initialize_multihost(..., device="cpu")`, calls
`function(rank, world_size, **kwargs)` and pickles what it returns. Each
process has `communicate(timeout=...)` and the group a timeout, so a
hang fails in bounded time."""

import os
import pickle
import subprocess
import sys
import uuid

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
GROUP_TIMEOUT_S = 60
PROCESS_TIMEOUT_S = 240


def run_ranks(target: str, world_size: int, tmp_path, **kwargs) -> list:
    """Each rank's result of `target` ("module:function") in rank order."""
    tag = uuid.uuid4().hex[:8]
    base = os.path.join(str(tmp_path), f"ranks-{tag}")
    os.makedirs(base)
    with open(os.path.join(base, "kwargs.pkl"), "wb") as f:
        pickle.dump(kwargs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import torch_dist_util as u; u._rank_main(*__import__('sys')"
         ".argv[1:])", target, str(rank), str(world_size), base],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world_size)]
    try:
        errors = []
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(timeout=PROCESS_TIMEOUT_S)
            if proc.returncode != 0:
                errors.append(f"rank {rank}: {err[-3000:]}")
        assert not errors, "\n".join(errors)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    results = []
    for rank in range(world_size):
        with open(os.path.join(base, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_main(target: str, rank: str, world_size: str, base: str):
    import importlib

    import torch

    from deepvariant_tpu_torch.parallel import distribute

    torch.set_num_threads(2)
    rank, world_size = int(rank), int(world_size)
    with open(os.path.join(base, "kwargs.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    got = distribute.initialize_multihost(
        f"file://{base}/store", world_size, rank, device="cpu",
        timeout_s=GROUP_TIMEOUT_S)
    assert got == (rank, world_size), got
    try:
        result = fn(rank, world_size, **kwargs)
    finally:
        distribute.shutdown()
    with open(os.path.join(base, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


# ---------------------------------------------------------------------------
# Functions the ranks run (torch and the port only)
# ---------------------------------------------------------------------------

def gather_counts(rank, world_size):
    """all_gather_counts of 10 + 3 * rank, its refusal of two counts, and
    this rank's round-robin items from the group."""
    from deepvariant_tpu_torch.parallel import distribute

    mesh = distribute.data_parallel_mesh("cpu")
    counts = distribute.all_gather_counts(10 + 3 * rank, mesh)
    try:
        distribute.all_gather_counts([1, 2], mesh)
        error = None
    except ValueError as e:
        error = str(e)
    return {"counts": counts, "error": error,
            "mesh": (mesh.world_size, mesh.rank, mesh.backend),
            "shard": distribute.host_shard_assignment(10)}


def _tensors(tree, dtype_of=None):
    import torch

    return {c: {k: torch.from_numpy(v.copy()).to(
        dtype_of(k) if dtype_of else torch.float32) for k, v in m.items()}
        for c, m in tree.items()}


def train_steps(rank, world_size, cases, variables, batches, model="twin",
                dtype="float32"):
    """For each case (TrainConfig fields), the data-parallel train and eval
    steps on this rank's rows of each global batch, from `variables`
    ({params, batch_stats} maps of numpy arrays): after each step the
    state in flax's layout, the loss, the confusion matrices and the eval
    step's loss and matrix. `model` is "twin" or "inception" (the full
    InceptionV3 with weights in `dtype` and a float32 head)."""
    import torch

    from deepvariant_tpu_torch.models import inception_v3 as iv3
    from deepvariant_tpu_torch.models.checkpoint import state_to_flax
    from deepvariant_tpu_torch.parallel.distribute import data_parallel_mesh
    from deepvariant_tpu_torch.training import train as port_train
    from deepvariant_tpu_torch.training.config import TrainConfig
    from torch_twin_util import TorchTwin

    torch.backends.cudnn.allow_tf32 = False
    dp = data_parallel_mesh("cpu")
    weights = getattr(torch, dtype)
    out = []
    for fields in cases:
        cfg = TrainConfig(**fields)
        if model == "twin":
            net, state_vars = TorchTwin(), _tensors(variables)
        else:
            channels = batches[0]["images"].shape[-1]
            net = iv3.InceptionV3(channels, dropout_rate=0.0, dtype=weights)
            state_vars = _tensors(variables, lambda k: torch.float32
                                  if k.startswith("classification")
                                  else weights)
        tx, _ = port_train.make_optimizer(cfg, 1)
        state = port_train.init_state(net, state_vars, tx)
        step = port_train.make_train_step(net, tx, cfg, dp)
        evaluate = port_train.make_eval_step(net, cfg, dp)
        accum = cfg.gradient_accumulation_steps
        record = []
        for batch in batches:
            local = {k: torch.from_numpy(v) for k, v in
                     dp.local_batch(batch, accum).items()}
            state, loss, cms = step(state, local)
            eval_loss, eval_cm = evaluate(state, {
                k: torch.from_numpy(v)
                for k, v in dp.local_batch(batch).items()})
            record.append({
                "state": state_to_flax(state), "loss": float(loss),
                "cms": {k: v.numpy() for k, v in cms.items()},
                "eval_loss": float(eval_loss), "eval_cm": eval_cm.numpy()})
        out.append(record)
    return out


def batch_norm_layer(rank, world_size, x, grad, momentum):
    """A training-mode BatchNorm over this rank's rows of the NCHW batch
    `x` with its statistics summed over the group: the output rows, their
    input gradient against `grad`'s rows, this rank's part of the bias
    gradient, and the running mean and variance."""
    import torch

    from deepvariant_tpu_torch.models import inception_v3 as iv3
    from deepvariant_tpu_torch.parallel.distribute import data_parallel_mesh

    dp = data_parallel_mesh("cpu")
    rows = dp.local_rows(len(x))
    bn = iv3.BatchNorm(x.shape[1], momentum=momentum)
    bn.train()
    with torch.no_grad():
        bn.bias.copy_(torch.linspace(-0.5, 0.5, x.shape[1]))
        bn.mean.fill_(0.25)
        bn.var.fill_(1.5)
    xin = torch.from_numpy(x[rows]).requires_grad_(True)
    with iv3.sync_batch_norm(bn, dp.gather_over_ranks):
        y = bn(xin)
    (y * torch.from_numpy(grad[rows])).sum().backward()
    return {"y": y.detach().numpy(), "dx": xin.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "mean": bn.mean.numpy(),
            "var": bn.var.numpy()}


def train_loop(rank, world_size, fields, experiment_dir, variables):
    """`train()` of the port over the group, its create_model building the
    twin with `variables` (flax layout); returns its tune metrics."""
    from deepvariant_tpu_torch.models import inception_v3 as iv3
    from deepvariant_tpu_torch.training import train as port_train
    from deepvariant_tpu_torch.training.config import TrainConfig
    from torch_twin_util import TorchTwin

    def create(c, height=100, width=221, dtype=None, generator=None,
               bn_momentum=0.9997, device="cuda"):
        model = TorchTwin(c, bn_momentum=bn_momentum)
        model.load_state_dict({
            **iv3.tree_from_flax(variables["params"]),
            **iv3.tree_from_flax(variables["batch_stats"])})
        return iv3.prepare_for_inference(model, device, dtype)

    port_train.create_model = create
    return port_train.train(TrainConfig(**fields), experiment_dir,
                            device="cpu", log_fn=lambda line: None)
