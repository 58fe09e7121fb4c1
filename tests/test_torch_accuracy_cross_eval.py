"""The port's cross-evaluation drivers (accuracy_chr20, accuracy_ont,
accuracy_deeptrio) against the JAX package's, on the CPU, stage by
stage; their fold and window geometry; and the nine drivers' `--device`.

The drivers read the same seeded stand-ins in both packages
(`testing/accuracy_inputs.py`) and train the twin model of
torch_train_util. Each package trains and evaluates its own folds: the
trained states are held to each other (1e-5 relative plus 1e-6
absolute), and the F1 JSON, built from calls of the EMA weights in both
packages (tests/torch_accuracy_util.py), must be equal, with every
stage-1 file byte for byte. accuracy_chr20 runs one fold through
`--train_region`/`--eval_region`: its tune carve (10 kb) and second
fold are the JAX script's literals, which the port keeps as the
defaults of TUNE_BP and SECOND_FOLD, so its train region spans 11 kb of
which the stand-in's reads cover 4; the folds of `--cross_eval` are
compared by recording the regions each package's run_cross_eval gives
`run`."""

import numpy as np
import pytest
import torch

from deepvariant_tpu_torch.testing import accuracy_inputs
from torch_accuracy_util import (
    JAX,
    PORT,
    assert_workdirs_equal,
    patch_both,
    run_main,
    script,
)

torch.set_num_threads(2)

FLAGS = ["--batch_size", "8", "--num_epochs", "1"]
DRIVERS = ("accuracy_sim", "accuracy_trio", "accuracy_somatic",
           "resume_somatic_eval", "accuracy_hybrid", "accuracy_longread",
           "accuracy_chr20", "accuracy_ont", "accuracy_deeptrio")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return accuracy_inputs.write_inputs(str(tmp_path_factory.mktemp("in")))


def run_each(name, argv, tmp_path, report_flag=None, suffix="json"):
    """One run of `name` per package with `argv` (plus `--device cpu`
    for the port); returns {package: printed JSON}."""
    out = {}
    for package in (PORT, JAX):
        args = ["--workdir", str(tmp_path / package)] + argv
        if report_flag:
            args += [report_flag, str(tmp_path / f"{package}.{suffix}")]
        if package == PORT:
            args += ["--device", "cpu"]
        out[package] = run_main(package, name, args)
    return out


def test_accuracy_chr20_fold_equals_jax(inputs, tmp_path, monkeypatch):
    patch_both(monkeypatch, inputs)
    out = run_each("accuracy_chr20", FLAGS + [
        "--train_region", "chr20:6,000-17,000",
        "--eval_region", "chr20:8,000-9,000"], tmp_path, "--report", "md")
    assert out[PORT] == out[JAX]
    assert out[PORT]["train_examples"] > 0
    assert out[PORT]["metrics"]["all"]["n_truth"] > 0
    assert assert_workdirs_equal(tmp_path / JAX, tmp_path / PORT) > 10
    with open(tmp_path / f"{JAX}.md") as f:
        want = f.read().replace("deepvariant_tpu.scripts",
                                "deepvariant_tpu_torch.scripts")
    with open(tmp_path / f"{PORT}.md") as f:
        assert f.read() == want


@pytest.mark.parametrize("name", ["accuracy_ont", "accuracy_deeptrio"])
def test_cross_eval_equals_jax(name, inputs, tmp_path, monkeypatch):
    patch_both(monkeypatch, inputs)
    out = run_each(name, FLAGS + ["--n_folds", "2"], tmp_path,
                   "--out_json")
    assert out[PORT] == out[JAX]
    assert len(out[PORT]["folds"]) == 2
    assert out[PORT]["eval_examples"] > 0
    assert assert_workdirs_equal(tmp_path / JAX, tmp_path / PORT) > 10


def test_chr20_cross_eval_folds_equal_jax(monkeypatch):
    """run_cross_eval gives `run` the same regions in both packages, at
    the reference's constants, and pools the folds alike."""
    calls = {}
    for package in (PORT, JAX):
        mod = script(package, "accuracy_chr20")
        calls[package] = []

        def run(workdir, _calls=calls[package], **kw):
            _calls.append((workdir[-5:], kw))
            i = len(_calls)
            m = {k: {"tp": 10 * i + j, "fn": i + j, "fp": j}
                 for j, k in enumerate(("snp", "indel", "all"))}
            return {"eval_region": kw["eval_region"], "train_examples": i,
                    "eval_examples": 2 * i, "tune_f1_weighted": 0.1 * i,
                    "metrics": m}

        monkeypatch.setattr(mod, "run", run)
        calls[package].append(mod.run_cross_eval("w/x", batch_size=4))
    assert calls[PORT] == calls[JAX]
    assert [c[1]["eval_region"] for c in calls[PORT][:2]] == [
        "chr20:10,080,000-10,100,000", "chr20:10,000,000-10,020,000"]


@pytest.mark.parametrize("n_folds,window,tune_bp", [
    (3, None, 3_000), (5, ("20", 10_000_000, 10_010_000), 1_000),
    (2, ("chr20", 17_000, 20_000), 500), (4, ("chr1", 0, 1_001), 7)])
def test_fold_regions_equal_jax(n_folds, window, tune_bp):
    got = list(script(PORT, "accuracy_ont")._fold_regions(
        n_folds, window=window, tune_bp=tune_bp))
    assert got == list(script(JAX, "accuracy_ont")._fold_regions(
        n_folds, window=window, tune_bp=tune_bp))
    assert len(got) == n_folds


def test_pool_metrics_equal_jax():
    rng = np.random.RandomState(0)
    folds = [{k: {"tp": int(rng.randint(0, 40)), "fn": int(rng.randint(0, 9)),
                  "fp": int(rng.randint(0, 9))}
              for k in ("snp", "indel", "all")} for _ in range(3)]
    folds.append({k: {"tp": 0, "fn": 0, "fp": 0}
                  for k in ("snp", "indel", "all")})
    assert script(PORT, "accuracy_chr20")._pool_metrics(folds) == \
        script(JAX, "accuracy_chr20")._pool_metrics(folds)


@pytest.mark.parametrize("name", DRIVERS)
def test_device_cuda_raises_without_a_card(name, tmp_path, monkeypatch):
    """`--device cuda` (the default) raises before any work when no card
    is visible; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--workdir", str(tmp_path / "w")]
    if name == "accuracy_longread":
        argv += ["--family", "pacbio"]
    mod = script(PORT, name)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        mod.main(argv + ["--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        mod.main(argv)
    assert not (tmp_path / "w" / "corpus_counts.json").exists()

