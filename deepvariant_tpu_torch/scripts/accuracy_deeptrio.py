"""End-to-end DeepTrio child accuracy demonstration.

Same capability proof as `accuracy_chr20`/`accuracy_ont` but for the
trio product: stage 1 generates STACKED child+parent pileups
(parent1 / child / parent2, 300 rows — deeptrio/make_examples.py
sample ordering), an InceptionV3 trains from scratch on the labeled
child examples, and held-out slices are called with the trio model
and scored against the GIAB HG001 truth.

Data (the reference's own deeptrio testdata, GRCh37 chr20; the trio
BAMs cover only 10,000,000-10,010,000 — ~1.5k reads each):
  * child   — HG001.chr20.10_10p1mb_sorted.bam
  * parents — NA12891 / NA12892 .chr20.10_10p1mb_sorted.bam
  * truth   — HG001 GIAB v3.3.2 high-confidence VCF (child truth;
    the parents have no truth in this image, so only child examples
    are emitted/scored — the same per-sample labeling rule the
    reference applies).

The 10 kb window is 5-fold cross-evaluated (2 kb eval slices, 1 kb
tune carve off the end of each training span) so every confident
truth call is scored exactly once by a model that never saw its
region. The full window is treated as confident for the train/eval
split; truth records GIAB dropped outside its confident regions then
surface as apparent FPs, making reported precision conservative.

The port's copy of the JAX package's driver (functions, flags,
constants, checkpoint names and JSON keys kept); training and
call_variants run on `--device` (default `cuda`, which raises without a
card; `cpu` runs float32).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from deepvariant_tpu_torch.device import resolve_device

TD = "/root/reference/deeptrio/testdata/input"
READS_CHILD = f"{TD}/HG001.chr20.10_10p1mb_sorted.bam"
READS_PARENT1 = f"{TD}/NA12891.chr20.10_10p1mb_sorted.bam"
READS_PARENT2 = f"{TD}/NA12892.chr20.10_10p1mb_sorted.bam"
REF = f"{TD}/hs37d5.chr20.fa.gz"
TRUTH_VCF = (
    f"{TD}/HG001_chr20_GRCh37_GIAB_highconf_CG-IllFB-IllGATKHC-Ion-10X"
    "-SOLID_CHROM1-X_v.3.3.2_highconf_PGandRTGphasetransfer.vcf.gz"
)

WINDOW = ("20", 10_000_000, 10_010_000)
TUNE_BP = 1_000


def run_fold(
    workdir: str,
    train_regions: Sequence[str],
    tune_region: str,
    eval_region: str,
    batch_size: int = 32,
    num_epochs: int = 40,
    learning_rate: float = 0.002,
    select: str = "final",
    log_fn=print,
    device="cuda",
) -> dict:
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.multisample import (
        make_multisample_examples_runner,
        trio_samples,
    )
    from deepvariant_tpu_torch.scripts.accuracy_sim import train_precision
    from deepvariant_tpu_torch.training.config import get_config
    from deepvariant_tpu_torch.training.data import DatasetConfig
    from deepvariant_tpu_torch.training import train as train_lib
    from deepvariant_tpu_torch.tools import vcf_eval

    os.makedirs(workdir, exist_ok=True)
    contig, lo, hi = WINDOW
    confident_bed = os.path.join(workdir, "confident.bed")
    with open(confident_bed, "w") as f:
        f.write(f"{contig}\t{lo}\t{hi}\n")

    samples = trio_samples(
        reads_child=READS_CHILD,
        reads_parent1=READS_PARENT1,
        reads_parent2=READS_PARENT2,
        sample_name_child="HG001",
    )

    def stage1(mode: str, regions: Sequence[str], out_name: str) -> dict:
        out = os.path.join(workdir, out_name)
        options = MakeExamplesOptions(
            reads_filename="",
            ref_filename=REF,
            examples_filename=out,
            mode=mode,
            regions=list(regions),
            sample_name="HG001",
        )
        if mode == "training":
            options.truth_variants_filename = TRUTH_VCF
            options.confident_regions_filename = confident_bed
        counts = make_multisample_examples_runner(
            options, samples, main_sample_index=1
        )
        log_fn(f"trio make_examples {mode} {list(regions)}: {counts}")
        return {"path": out, "counts": counts}

    train_ex = stage1("training", train_regions, "train.tfrecord.gz")
    tune_ex = stage1("training", [tune_region], "tune.tfrecord.gz")

    for name, ex in (("train", train_ex), ("tune", tune_ex)):
        DatasetConfig(
            name=f"trio-{name}",
            tfrecord_path=ex["path"],
            num_examples=ex["counts"]["examples"],
        ).write(os.path.join(workdir, f"{name}_dataset.json"))

    config = get_config("wgs")
    config.train_dataset_config = os.path.join(
        workdir, "train_dataset.json"
    )
    config.tune_dataset_config = os.path.join(workdir, "tune_dataset.json")
    config.batch_size = batch_size
    config.num_epochs = num_epochs
    config.learning_rate = learning_rate
    config.early_stopping_patience = num_epochs
    config.num_validation_examples = 0
    # Same small-corpus adjustments as accuracy_chr20 (measured there).
    config.bn_momentum = 0.90
    config.learning_rate_decay_rate = 0.90
    config.learning_rate_num_epochs_per_decay = 1.0
    device = train_precision(config, device)

    exp_dir = os.path.join(workdir, "experiment")
    results = train_lib.train(config, exp_dir, device=device,
                              log_fn=log_fn)
    if select == "final":
        # The tune carve holds a handful of examples; tune-best
        # selection over that is noise. The per-epoch LR decay makes
        # the run converge, so the final checkpoint is the default.
        ckpt_dir = os.path.join(exp_dir, "checkpoints")
        epochs = sorted(
            int(f.split("-")[1].split(".")[0])
            for f in os.listdir(ckpt_dir)
            if f.startswith("ckpt-")
        )
        ckpt = os.path.join(ckpt_dir, f"ckpt-{epochs[-1]}.msgpack")
    else:
        ckpt = os.path.join(exp_dir, "checkpoints", "best.msgpack")

    calling_ex = stage1("calling", [eval_region], "calling.tfrecord.gz")

    from deepvariant_tpu_torch.scripts.accuracy_sim import call_checkpoint
    from deepvariant_tpu_torch.postprocess.pipeline import postprocess_variants
    from deepvariant_tpu_torch.io.fasta import FastaReader

    cvo_path = os.path.join(workdir, "cvo.tfrecord.gz")
    stats = call_checkpoint(ckpt, calling_ex["path"], cvo_path, batch_size, device)
    log_fn(f"call_variants: {stats}")

    vcf_out = os.path.join(workdir, "child.vcf.gz")
    ref_reader = FastaReader(REF)
    pp = postprocess_variants(
        cvo_path, vcf_out, ref_reader.contigs, sample_name="HG001"
    )
    log_fn(f"postprocess: {pp}")

    metrics = vcf_eval.evaluate(
        TRUTH_VCF, vcf_out,
        confident_bed=confident_bed,
        region=eval_region.replace(",", ""),
    )
    return {
        "eval_region": eval_region,
        "train_examples": train_ex["counts"]["examples"],
        "eval_examples": calling_ex["counts"]["examples"],
        "tune_f1_weighted": round(
            results.get("tune/f1_weighted", 0.0), 5
        ),
        "metrics": metrics,
    }


def run_cross_eval(
    workdir: str, n_folds: int = 5, log_fn=print, **kwargs
) -> dict:
    from deepvariant_tpu_torch.scripts.accuracy_chr20 import _pool_metrics
    from deepvariant_tpu_torch.scripts.accuracy_ont import _fold_regions

    fold_results = []
    for i, (train_rs, tune_r, eval_r) in enumerate(
        _fold_regions(n_folds, window=WINDOW, tune_bp=TUNE_BP)
    ):
        result = run_fold(
            os.path.join(workdir, f"fold{i}"),
            train_rs, tune_r, eval_r,
            log_fn=log_fn, **kwargs,
        )
        log_fn(f"fold {i}: {json.dumps(result)}")
        fold_results.append(result)
    return {
        "eval_region": " + ".join(r["eval_region"] for r in fold_results),
        "train_examples": sum(r["train_examples"] for r in fold_results),
        "eval_examples": sum(r["eval_examples"] for r in fold_results),
        "tune_f1_weighted": round(
            sum(r["tune_f1_weighted"] for r in fold_results)
            / len(fold_results), 5,
        ),
        "folds": fold_results,
        "metrics": _pool_metrics([r["metrics"] for r in fold_results]),
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser("accuracy_deeptrio")
    p.add_argument("--workdir", required=True)
    p.add_argument("--n_folds", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_epochs", type=int, default=40)
    p.add_argument("--learning_rate", type=float, default=0.002)
    p.add_argument("--select", choices=("best", "final"),
                   default="final")
    p.add_argument("--out_json", default="")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where training and call_variants run; cuda "
                        "raises without a card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    result = run_cross_eval(
        args.workdir,
        n_folds=args.n_folds,
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        learning_rate=args.learning_rate,
        select=args.select,
        device=device,
    )
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
