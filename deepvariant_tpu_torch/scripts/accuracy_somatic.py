"""DeepSomatic accuracy at training scale: simulated tumor/normal
pairs, measured somatic F1 with VAF-stratified recall.

No tumor data exists in this image, so the corpus comes from the
tumor/normal simulator (training/simulate_family.py): a germline
diploid genome shared by both samples, somatic variants added to the
tumor on one haplotype with per-site VAFs drawn log-uniform over
5-50%, and sequencing-error hotspots SHARED between the pair (the
hard negative: an artifact in tumor+normal is not somatic).

Pipeline (all production paths):
  1. label tumor candidates through the DeepSomatic stacked path
     ([normal, tumor] x 100 rows -> 200-row examples,
     make_examples/multisample.py; tumor-only candidates,
     min_fraction_multiplier=inf semantics). Training truth uses the
     DeepSomatic class convention (postprocess _apply_somatic_filters
     / reference vcf_writer.cc WriteSomatic): germline -> GT 0/1
     (class 1 = GERMLINE), somatic -> GT 1/1 (class 2 = SOMATIC);
  2. train InceptionV3 (device-resident loop);
  3. evaluate HELD-OUT fresh-seed tumor/normal replicates over spans
     disjoint from training, through make_examples -> CNN ->
     postprocess(process_somatic=True), keeping PASS records only;
     score vs the somatic truth with Wilson 95% CIs and report
     recall stratified by true VAF bin.

The port's copy of the JAX package's driver (stages, flags, constants,
checkpoint names and JSON keys kept); training and call_variants run
on `--device` (default `cuda`, which raises without a card; `cpu` runs
float32).

Reference anchors: deepvariant/make_examples_somatic.py,
docs/deepsomatic-case-study.md (published somatic accuracy),
postprocess vcf_writer.cc WriteSomatic (GERMLINE semantics).

GRCh38 chr20 span allocation: somatic train 0.2-2.0M | tune
4.2-4.35M | eval 2.2-4.0M (disjoint within this product).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from deepvariant_tpu_torch.device import resolve_device
from deepvariant_tpu_torch.scripts.accuracy_trio import (
    GRCH38_10M,
    CONTIG,
    TRAIN_WINDOWS,
    TUNE_WINDOWS,
    EVAL_WINDOWS,
    _chunk_regions,
    _merge_tfrecords_capped,
    run_multisample_fanout,
)

# Somatic burden raised over the simulator default for label balance
# (germline candidates outnumber somatic ~10:1 otherwise).
SOMATIC_SNV_RATE = 1.0 / 1_500.0
SOMATIC_INDEL_RATE = 1.0 / 7_500.0

VAF_BINS = [(0.05, 0.1), (0.1, 0.2), (0.2, 0.35), (0.35, 0.5)]


def _somatic_jobs(
    sim: Dict[str, object],
    windows: Sequence[Tuple[int, int]],
    outdir: str,
    mode: str,
    tag: str,
) -> Tuple[List[dict], List[str]]:
    jobs, parts = [], []
    for i, region in enumerate(_chunk_regions(windows)):
        part = os.path.join(outdir, f"{tag}{i:03d}.tfrecord.gz")
        job = dict(
            kind="somatic",
            samples=dict(
                reads_tumor=sim["bam_tumor"],
                reads_normal=sim["bam_normal"],
                sample_name_tumor="tumor",
                sample_name_normal="normal",
            ),
            reads_filename=sim["bam_tumor"],
            ref_filename=GRCH38_10M,
            examples_filename=part,
            mode=mode,
            regions=[region],
            realigner_enabled=True,
            sample_name="tumor",
        )
        if mode == "training":
            job.update(
                truth_variants_filename=sim["truth_training"],
                confident_regions_filename=sim["confident_bed"],
            )
        jobs.append(job)
        parts.append(part)
    return jobs, parts


def simulate_replicate(
    outdir: str, windows, seed: int, log_fn=print
) -> Dict[str, object]:
    from deepvariant_tpu_torch.scripts import accuracy_sim
    from deepvariant_tpu_torch.training.simulate_family import (
        SomaticSimConfig,
        simulate_somatic_corpus,
    )

    t0 = time.time()
    sim = simulate_somatic_corpus(SomaticSimConfig(
        ref_path=GRCH38_10M, contig=CONTIG, windows=windows,
        seed=seed,
        somatic_snv_rate=SOMATIC_SNV_RATE,
        somatic_indel_rate=SOMATIC_INDEL_RATE,
        **accuracy_sim.DEFAULT_TEMPLATE,
    ), outdir)
    log_fn(
        f"somatic sim seed {seed}: {sim['n_somatic']} somatic / "
        f"{sim['n_germline']} germline variants in "
        f"{time.time() - t0:.0f}s"
    )
    return sim


def generate_corpus(
    workdir: str, seeds: Sequence[int], num_workers: int,
    train_cap: Optional[int] = 15_000, log_fn=print
) -> Dict[str, int]:
    from deepvariant_tpu_torch.scripts.accuracy_sim import _merge_tfrecords
    from deepvariant_tpu_torch.training.data import DatasetConfig

    train_parts: List[str] = []
    for seed in seeds:
        rep_dir = os.path.join(workdir, f"rep{seed}")
        sim = simulate_replicate(rep_dir, TRAIN_WINDOWS, seed, log_fn)
        t0 = time.time()
        jobs, parts = _somatic_jobs(
            sim, TRAIN_WINDOWS, rep_dir, "training", "part"
        )
        run_multisample_fanout(jobs, num_workers, log_fn=lambda _: None)
        log_fn(f"rep{seed}: labeled in {time.time() - t0:.0f}s")
        train_parts += parts

    tune_dir = os.path.join(workdir, "tune_sim")
    tune_sim = simulate_replicate(
        tune_dir, TUNE_WINDOWS, max(seeds) + 7919, log_fn
    )
    tune_jobs, tune_parts = _somatic_jobs(
        tune_sim, TUNE_WINDOWS, tune_dir, "training", "tune"
    )
    run_multisample_fanout(tune_jobs, num_workers, log_fn=lambda _: None)

    train_path = os.path.join(workdir, "train.tfrecord.gz")
    tune_path = os.path.join(workdir, "tune.tfrecord.gz")
    counts = {
        "train": _merge_tfrecords_capped(
            train_parts, train_path, train_cap
        ),
        "tune": _merge_tfrecords(tune_parts, tune_path),
    }
    log_fn(f"corpus: {counts['train']} train / {counts['tune']} tune")
    DatasetConfig(
        name="somatic-sim-train", tfrecord_path=train_path,
        num_examples=counts["train"],
    ).write(os.path.join(workdir, "train_dataset.json"))
    DatasetConfig(
        name="somatic-sim-tune", tfrecord_path=tune_path,
        num_examples=counts["tune"],
    ).write(os.path.join(workdir, "tune_dataset.json"))
    return counts


def train_model(
    workdir: str,
    batch_size: int,
    num_epochs: int,
    learning_rate: float,
    device: str,
    class_weights: str = "1,1,4",
    log_fn=print,
) -> str:
    from deepvariant_tpu_torch.scripts.accuracy_sim import train_precision
    from deepvariant_tpu_torch.training.config import get_config
    from deepvariant_tpu_torch.training.train_resident import train_resident

    config = get_config("wgs")
    config.train_dataset_config = os.path.join(
        workdir, "train_dataset.json"
    )
    config.tune_dataset_config = os.path.join(
        workdir, "tune_dataset.json"
    )
    config.batch_size = batch_size
    config.num_epochs = num_epochs
    config.learning_rate = learning_rate
    config.early_stopping_patience = num_epochs
    config.num_validation_examples = 0
    config.bn_momentum = 0.99
    config.learning_rate_decay_rate = 0.94
    config.learning_rate_num_epochs_per_decay = 1.0
    config.warmup_steps = 0
    # Somatic sites (class 2) are the minority class the product
    # exists for; weight them up so recall at low VAF trains.
    config.class_weights = class_weights

    device = train_precision(config, device)
    exp_dir = os.path.join(workdir, "experiment")
    results = train_resident(config, exp_dir, device=device,
                             log_fn=log_fn)
    log_fn(f"training done: best tune/f1_weighted="
           f"{results.get('best_metric', 0):.4f} "
           f"at epoch {results.get('best_epoch')}")
    return os.path.join(exp_dir, "checkpoints", "final.msgpack")


def evaluate_model(
    workdir: str,
    ckpt: str,
    batch_size: int,
    num_workers: int,
    eval_seed: int,
    log_fn=print,
    device="cuda",
) -> Dict[str, object]:
    from deepvariant_tpu_torch.io.fasta import FastaReader
    from deepvariant_tpu_torch.io.vcf import VcfReader
    from deepvariant_tpu_torch.postprocess.pipeline import postprocess_variants
    from deepvariant_tpu_torch.scripts.accuracy_sim import call_checkpoint
    from deepvariant_tpu_torch.scripts.accuracy_sim import _merge_tfrecords
    from deepvariant_tpu_torch.tools import vcf_eval

    ev_dir = os.path.join(workdir, "eval")
    os.makedirs(ev_dir, exist_ok=True)
    sim = simulate_replicate(
        os.path.join(ev_dir, "sim"), EVAL_WINDOWS, eval_seed, log_fn
    )

    calling_jobs, calling_parts = _somatic_jobs(
        sim, EVAL_WINDOWS, ev_dir, "calling", "calling"
    )
    # Oracle pass (truth-labeled training-mode examples): which
    # somatic sites even BECOME candidates under the reference-parity
    # thresholds (vsc_min_fraction_snps 0.12 / indels 0.06,
    # make_examples_options.py:327-343 — DeepSomatic changes only the
    # multiplier to inf, make_examples_somatic.py:149). Below ~0.12
    # VAF the ceiling, not the CNN, bounds recall.
    oracle_jobs, oracle_parts = _somatic_jobs(
        sim, EVAL_WINDOWS, ev_dir, "training", "oracle"
    )
    t0 = time.time()
    run_multisample_fanout(calling_jobs + oracle_jobs, num_workers,
                           log_fn=lambda _: None)
    log_fn(f"eval stage-1 in {time.time() - t0:.0f}s")

    calling_path = os.path.join(ev_dir, "calling.tfrecord.gz")
    _merge_tfrecords(calling_parts, calling_path)
    oracle_path = os.path.join(ev_dir, "oracle.tfrecord.gz")
    _merge_tfrecords(oracle_parts, oracle_path)

    cvo_path = os.path.join(ev_dir, "cvo.tfrecord.gz")
    call_checkpoint(ckpt, calling_path, cvo_path, batch_size, device)
    vcf_out = os.path.join(ev_dir, "somatic.vcf.gz")
    postprocess_variants(
        cvo_path, vcf_out, FastaReader(GRCH38_10M).contigs,
        sample_name="tumor", process_somatic=True,
    )

    region = (
        f"{CONTIG}:{EVAL_WINDOWS[0][0]}-{EVAL_WINDOWS[-1][1]}"
    )
    # PASS-only somatic calls vs the somatic truth (GT 1/1 both
    # sides; vcf_eval already drops non-PASS query records).
    model_metrics = vcf_eval.evaluate(
        sim["truth_somatic"], vcf_out,
        confident_bed=sim["confident_bed"], region=region,
    )

    # VAF-stratified recall: which true somatic sites were called
    # PASS with GT 1/1, binned by the drawn VAF.
    with VcfReader(vcf_out) as r:
        called = {
            (v.reference_name, v.start): v for v in r
            if v.filter in (["PASS"], ["."])
            and v.calls and sorted(v.calls[0].genotype) == [1, 1]
        }
    # Candidate-reachable somatic sites from the oracle pass: a
    # class-2 labeled example exists at the locus.
    from deepvariant_tpu_torch.io import tfrecord
    from deepvariant_tpu_torch.io.examples import parse_example

    reachable = set()
    for buf in tfrecord.read_tfrecords(oracle_path):
        ex = parse_example(buf)
        if int(ex.label or 0) == 2:
            reachable.add(ex.variant.start)

    vaf_by_pos = sim["vaf_by_pos"]
    strata = []
    for lo_v, hi_v in VAF_BINS:
        in_bin = [
            v for v in sim["somatic_variants"]
            if lo_v <= vaf_by_pos[v.pos] < hi_v
        ]
        tp = sum(
            1 for v in in_bin if (CONTIG, v.pos) in called
        )
        n_reach = sum(1 for v in in_bin if v.pos in reachable)
        tp_reach = sum(
            1 for v in in_bin
            if v.pos in reachable and (CONTIG, v.pos) in called
        )
        ci = vcf_eval.wilson_ci(tp, len(in_bin))
        strata.append({
            "vaf_bin": [lo_v, hi_v],
            "n": len(in_bin),
            "called": tp,
            "recall": round(tp / len(in_bin), 4) if in_bin else None,
            "recall_ci95": [round(x, 4) for x in ci],
            "candidate_reachable": n_reach,
            "ceiling_recall": (
                round(n_reach / len(in_bin), 4) if in_bin else None
            ),
            "recall_of_reachable": (
                round(tp_reach / n_reach, 4) if n_reach else None
            ),
        })
        log_fn(
            f"VAF [{lo_v:.2f},{hi_v:.2f}): recall {tp}/{len(in_bin)} "
            f"(ceiling {n_reach}/{len(in_bin)}, of-reachable "
            f"{tp_reach}/{n_reach})"
        )

    # Germline leak-through: called-PASS records at true germline
    # sites (should be suppressed to GERMLINE/0-0 by class 1).
    germline_pos = {v.pos for v in sim["germline_variants"]}
    leaks = sum(
        1 for (c, pos) in called if pos in germline_pos
    )
    log_fn(
        f"somatic: all-F1 {model_metrics['all']['f1']:.4f} "
        f"(snp {model_metrics['snp']['f1']:.4f} / indel "
        f"{model_metrics['indel']['f1']:.4f}); germline leaks "
        f"{leaks}/{len(germline_pos)}"
    )
    # Overall ceiling + the reachable-sites decomposition: model F1
    # among candidate-reachable somatic sites isolates CNN error from
    # the threshold-bounded candidate stage.
    all_pos = [v.pos for v in sim["somatic_variants"]]
    n_reachable = sum(1 for p_ in all_pos if p_ in reachable)
    called_reach = sum(
        1 for p_ in all_pos
        if p_ in reachable and (CONTIG, p_) in called
    )
    ceiling = round(n_reachable / len(all_pos), 4) if all_pos else None
    return {
        "region": region,
        "model": model_metrics,
        "vaf_strata": strata,
        "candidate_ceiling_recall": ceiling,
        "candidate_reachable": n_reachable,
        "recall_of_reachable": (
            round(called_reach / n_reachable, 4)
            if n_reachable else None
        ),
        "germline_sites": len(germline_pos),
        "germline_leaks": leaks,
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser("accuracy_somatic")
    p.add_argument("--workdir", required=True)
    p.add_argument("--stages", default="gen,train,eval")
    p.add_argument("--seeds", default="601,602")
    p.add_argument("--eval_seed", type=int, default=90666)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_epochs", type=int, default=30)
    p.add_argument("--learning_rate", type=float, default=0.004)
    p.add_argument("--class_weights", default="1,1,4")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where training and call_variants run; cuda "
                        "raises without a card")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--report", default="")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    stages = set(args.stages.split(","))
    seeds = [int(s) for s in args.seeds.split(",")]
    os.makedirs(args.workdir, exist_ok=True)
    result: Dict[str, object] = {"seeds": seeds}

    counts_path = os.path.join(args.workdir, "corpus_counts.json")
    if "gen" in stages:
        counts = generate_corpus(
            args.workdir, seeds, args.num_workers
        )
        with open(counts_path, "w") as f:
            json.dump(counts, f)
    elif os.path.exists(counts_path):
        with open(counts_path) as f:
            counts = json.load(f)
    else:
        counts = {}
    result["train_examples"] = counts.get("train")
    result["tune_examples"] = counts.get("tune")

    ckpt = args.checkpoint or os.path.join(
        args.workdir, "experiment", "checkpoints", "final.msgpack"
    )
    if "train" in stages and not args.checkpoint:
        train_model(
            args.workdir, args.batch_size, args.num_epochs,
            args.learning_rate, device, args.class_weights,
        )
    if "eval" in stages:
        result["eval"] = evaluate_model(
            args.workdir, ckpt, args.batch_size, args.num_workers,
            args.eval_seed, device=device,
        )
    report = args.report or os.path.join(args.workdir, "report.json")
    with open(report, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result.get("eval", result)))


if __name__ == "__main__":
    main()
