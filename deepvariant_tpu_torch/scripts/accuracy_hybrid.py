"""Hybrid PACBIO+Illumina model: corpus, training, held-out eval
(round-5 directive #8).

The reference's best published accuracy is the hybrid model (SNP F1
0.9992 / indel 0.9968, docs/metrics.md:43-44): ONE BAM containing
both PacBio HiFi long reads and Illumina paired short reads, called
with --model_type=HYBRID_PACBIO_ILLUMINA (channels 1-6 + 19,
make_examples/presets.py:62).

No real hybrid pairing with truth exists in this image (the only HiFi
BAM is HG003, no HG003 truth — see ACCURACY.md's round-4 audit), so
both layers are SIMULATED over one shared diploid genome:

  1. per window, sample ONE phased variant set (the Illumina
     simulator's calibrated rates);
  2. emit Illumina paired reads from the NA12878-fitted error model
     (training/simulate.py) AND PacBio HiFi long reads from the
     HG003-template-fitted model (training/simulate_longread.py) over
     the SAME haplotypes, into one coordinate-sorted BAM;
  3. label through `make_examples --mode training` with the HYBRID
     preset; train the device-resident InceptionV3;
  4. evaluate a HELD-OUT fresh-seed hybrid replicate over disjoint
     spans through the full pipeline, Wilson CIs + oracle ceiling +
     FN audit.

The port's copy of the JAX package's driver (stages, flags, constants,
checkpoint names and JSON keys kept); training and call_variants run
on `--device` (default `cuda`, which raises without a card; `cpu` runs
float32).

GRCh38 chr20 span allocation: hybrid train 0.2-2.0M | tune
4.2-4.35M | eval 2.2-4.0M (disjoint within this product; other
products' sim corpora reuse spans independently).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.device import resolve_device
from deepvariant_tpu_torch.scripts.accuracy_sim import (
    _merge_tfrecords,
    _run_make_examples_fanout,
    call_checkpoint,
    train_precision,
)

TESTDATA = "/root/reference/deepvariant/testdata/input"
GRCH38_10M = f"{TESTDATA}/grch38.chr20_and_21_10M.fa.gz"
CONTIG = "chr20"
ILLUMINA_TEMPLATE = f"{TESTDATA}/NA12878_S1.chr20.10_10p1mb.bam"
ILLUMINA_TEMPLATE_REGION = ("chr20", 10_000_000, 10_080_000)
ILLUMINA_TEMPLATE_REF = (
    f"{TESTDATA}/ucsc.hg19.chr20.unittest.fasta.gz"
)
PACBIO_TEMPLATE = f"{TESTDATA}/test_pacbio.chr20_100kbp_at_9mb.bam"
PACBIO_TEMPLATE_REGION = ("chr20", 8_980_000, 9_100_000)

TRAIN_WINDOWS = [(200_000, 1_100_000), (1_100_000, 2_000_000)]
TUNE_WINDOWS = [(4_200_000, 4_350_000)]
EVAL_WINDOWS = [(2_200_000, 3_100_000), (3_100_000, 4_000_000)]

_CHUNK = 64_000


def simulate_hybrid_corpus(
    outdir: str,
    windows: Sequence[Tuple[int, int]],
    seed: int,
    illumina_coverage: float = 35.0,
    pacbio_coverage: float = 30.0,
    log_fn=print,
) -> Dict[str, object]:
    """One hybrid replicate: both read layers over one genome."""
    from deepvariant_tpu_torch.core.types import Range, Variant, VariantCall
    from deepvariant_tpu_torch.io.bam_writer import (
        BamWriter,
        build_bam_index,
    )
    from deepvariant_tpu_torch.io.fasta import FastaReader
    from deepvariant_tpu_torch.io.vcf import VcfHeader, VcfWriter
    from deepvariant_tpu_torch.training.simulate import (
        QualityModel,
        SimConfig,
        build_haplotype,
        sample_hotspots,
        sample_variants,
        simulate_window_reads,
    )
    from deepvariant_tpu_torch.training.simulate_longread import (
        LongReadModel,
        LongReadSimConfig,
        simulate_long_window_reads,
    )

    os.makedirs(outdir, exist_ok=True)
    t0 = time.time()
    rng = np.random.default_rng(seed)
    ref_reader = FastaReader(GRCH38_10M)
    contig_info = next(
        c for c in ref_reader.contigs if c.name == CONTIG
    )
    ref = np.frombuffer(
        ref_reader.query(
            Range(CONTIG, 0, contig_info.n_bases)
        ).upper().encode(),
        np.uint8,
    )

    base = SimConfig(
        ref_path=GRCH38_10M, contig=CONTIG, windows=windows,
        seed=seed,
        template_bam=ILLUMINA_TEMPLATE,
        template_region=ILLUMINA_TEMPLATE_REGION,
        coverage=illumina_coverage,
    )
    qual_model = QualityModel.from_bam(
        ILLUMINA_TEMPLATE, Range(*ILLUMINA_TEMPLATE_REGION)
    )
    base = dataclasses.replace(
        base,
        read_length=qual_model.read_length,
        fragment_mean=qual_model.fragment_mean,
        fragment_std=qual_model.fragment_std,
    )
    lr_cfg = LongReadSimConfig(
        ref_path=GRCH38_10M, contig=CONTIG, windows=windows,
        seed=seed, coverage=pacbio_coverage,
        template_bam=PACBIO_TEMPLATE,
        template_region=PACBIO_TEMPLATE_REGION,
        template_ref_path=GRCH38_10M,
    )
    lr_model = LongReadModel.from_bam(
        PACBIO_TEMPLATE, Range(*PACBIO_TEMPLATE_REGION),
        ref_path=GRCH38_10M,
    )

    all_variants = []
    all_reads = []
    for w_idx, (lo, hi) in enumerate(windows):
        variants = sample_variants(rng, ref, lo, hi, base)
        hotspots = sample_hotspots(rng, ref, lo, hi, base, variants)
        haps = [
            build_haplotype(ref, lo, hi, variants, hap)
            for hap in (0, 1)
        ]
        haps.append((
            ref[lo:hi].copy(), np.arange(lo, hi, dtype=np.int64)
        ))
        all_reads.extend(simulate_window_reads(
            rng, haps, base, qual_model, CONTIG, hotspots,
            name_prefix=f"hyb{seed}w{w_idx}il",
            variants=variants, window=(lo, hi),
        ))
        hp_r0 = lr_model.calibrate_hp_rate(ref, lo, hi)
        all_reads.extend(simulate_long_window_reads(
            rng, haps, lr_cfg, lr_model, hotspots,
            name_prefix=f"hyb{seed}w{w_idx}pb",
            window=(lo, hi), hp_r0=hp_r0,
        ))
        all_variants.extend(variants)

    all_reads.sort(key=lambda r: r.position)
    bam = os.path.join(outdir, "hybrid.bam")
    writer = BamWriter(bam, ref_reader.contigs, sample_name="SIM")
    for rd in all_reads:
        writer.write_read(rd)
    writer.close()
    build_bam_index(bam)

    vcf_path = os.path.join(outdir, "truth.vcf.gz")
    vcf_writer = VcfWriter(
        vcf_path, VcfHeader(ref_reader.contigs, ["SIM"])
    )
    for v in sorted(all_variants, key=lambda x: x.pos):
        vcf_writer.write(Variant(
            reference_name=CONTIG, start=v.pos,
            end=v.pos + len(v.ref), reference_bases=v.ref,
            alternate_bases=[v.alt], quality=50.0, filter=["PASS"],
            calls=[VariantCall(
                call_set_name="SIM", genotype=list(v.genotype),
                is_phased=True,
            )],
        ))
    vcf_writer.close()
    bed = os.path.join(outdir, "confident.bed")
    with open(bed, "w") as f:
        for lo, hi in windows:
            f.write(f"{CONTIG}\t{lo}\t{hi}\n")
    log_fn(
        f"hybrid sim seed {seed}: {len(all_variants)} variants, "
        f"{len(all_reads)} reads in {time.time() - t0:.0f}s"
    )
    return {
        "bam": bam,
        "truth_vcf": vcf_path,
        "confident_bed": bed,
        "n_variants": len(all_variants),
        "n_reads": len(all_reads),
    }


def _jobs(sim, windows, outdir, mode, tag):
    jobs, parts = [], []
    for i, (lo, hi) in enumerate(
        (s, min(s + _CHUNK, hi))
        for lo, hi in windows
        for s in range(lo, hi, _CHUNK)
    ):
        part = os.path.join(outdir, f"{tag}{i:03d}.tfrecord.gz")
        job = dict(
            reads_filename=sim["bam"], ref_filename=GRCH38_10M,
            examples_filename=part, mode=mode,
            regions=[f"{CONTIG}:{lo}-{hi}"],
            realigner_enabled=True,
            model_preset="HYBRID_PACBIO_ILLUMINA",
        )
        if mode == "training":
            job.update(
                truth_variants_filename=sim["truth_vcf"],
                confident_regions_filename=sim["confident_bed"],
            )
        jobs.append(job)
        parts.append(part)
    return jobs, parts


def generate_corpus(
    workdir: str, seeds: Sequence[int], num_workers: int, log_fn=print
) -> Dict[str, int]:
    from deepvariant_tpu_torch.training.data import DatasetConfig

    train_parts: List[str] = []
    for seed in seeds:
        rep_dir = os.path.join(workdir, f"rep{seed}")
        sim = simulate_hybrid_corpus(
            rep_dir, TRAIN_WINDOWS, seed, log_fn=log_fn
        )
        t0 = time.time()
        jobs, parts = _jobs(sim, TRAIN_WINDOWS, rep_dir, "training",
                            "part")
        _run_make_examples_fanout(jobs, num_workers,
                                  log_fn=lambda _: None)
        log_fn(f"rep{seed}: labeled in {time.time() - t0:.0f}s")
        train_parts += parts

    tune_dir = os.path.join(workdir, "tune_sim")
    tune_sim = simulate_hybrid_corpus(
        tune_dir, TUNE_WINDOWS, max(seeds) + 7919, log_fn=log_fn
    )
    tune_jobs, tune_parts = _jobs(
        tune_sim, TUNE_WINDOWS, tune_dir, "training", "tune"
    )
    _run_make_examples_fanout(tune_jobs, num_workers,
                              log_fn=lambda _: None)

    train_path = os.path.join(workdir, "train.tfrecord.gz")
    tune_path = os.path.join(workdir, "tune.tfrecord.gz")
    counts = {
        "train": _merge_tfrecords(train_parts, train_path),
        "tune": _merge_tfrecords(tune_parts, tune_path),
    }
    log_fn(f"corpus: {counts['train']} train / {counts['tune']} tune")
    DatasetConfig(
        name="hybrid-sim-train", tfrecord_path=train_path,
        num_examples=counts["train"],
    ).write(os.path.join(workdir, "train_dataset.json"))
    DatasetConfig(
        name="hybrid-sim-tune", tfrecord_path=tune_path,
        num_examples=counts["tune"],
    ).write(os.path.join(workdir, "tune_dataset.json"))
    return counts


def train_model(
    workdir, batch_size, num_epochs, learning_rate, device,
    log_fn=print,
) -> str:
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

    device = train_precision(config, device)
    exp_dir = os.path.join(workdir, "experiment")
    results = train_resident(config, exp_dir, device=device,
                             log_fn=log_fn)
    log_fn(f"training done: best tune/f1_weighted="
           f"{results.get('best_metric', 0):.4f}")
    return os.path.join(exp_dir, "checkpoints", "final.msgpack")


def evaluate_model(
    workdir, ckpt, batch_size, num_workers, eval_seed, log_fn=print,
    device="cuda",
) -> Dict[str, object]:
    from deepvariant_tpu_torch.io.fasta import FastaReader
    from deepvariant_tpu_torch.labeler import labeled_examples_to_vcf
    from deepvariant_tpu_torch.postprocess.pipeline import postprocess_variants
    from deepvariant_tpu_torch.tools import fn_audit, vcf_eval

    ev_dir = os.path.join(workdir, "eval")
    os.makedirs(ev_dir, exist_ok=True)
    sim = simulate_hybrid_corpus(
        os.path.join(ev_dir, "sim"), EVAL_WINDOWS, eval_seed,
        log_fn=log_fn,
    )
    calling_jobs, calling_parts = _jobs(
        sim, EVAL_WINDOWS, ev_dir, "calling", "calling"
    )
    oracle_jobs, oracle_parts = _jobs(
        sim, EVAL_WINDOWS, ev_dir, "training", "oracle"
    )
    t0 = time.time()
    _run_make_examples_fanout(
        calling_jobs + oracle_jobs, num_workers, log_fn=lambda _: None
    )
    log_fn(f"eval stage-1 in {time.time() - t0:.0f}s")

    calling_path = os.path.join(ev_dir, "calling.tfrecord.gz")
    oracle_path = os.path.join(ev_dir, "oracle.tfrecord.gz")
    _merge_tfrecords(calling_parts, calling_path)
    _merge_tfrecords(oracle_parts, oracle_path)

    cvo_path = os.path.join(ev_dir, "cvo.tfrecord.gz")
    call_checkpoint(ckpt, calling_path, cvo_path, batch_size, device)
    vcf_out = os.path.join(ev_dir, "out.vcf.gz")
    postprocess_variants(
        cvo_path, vcf_out, FastaReader(GRCH38_10M).contigs,
        sample_name="SIM",
    )
    region = f"{CONTIG}:{EVAL_WINDOWS[0][0]}-{EVAL_WINDOWS[-1][1]}"
    model_metrics = vcf_eval.evaluate(
        sim["truth_vcf"], vcf_out,
        confident_bed=sim["confident_bed"], region=region,
    )
    oracle_vcf = os.path.join(ev_dir, "oracle.vcf.gz")
    labeled_examples_to_vcf.run(
        oracle_path, GRCH38_10M, oracle_vcf, sample_name="SIM",
    )
    oracle_metrics = vcf_eval.evaluate(
        sim["truth_vcf"], oracle_vcf,
        confident_bed=sim["confident_bed"], region=region,
    )
    audit = fn_audit.run(
        sim["truth_vcf"], vcf_out, cvo_path,
        confident_bed=sim["confident_bed"], region=region,
    )
    with open(os.path.join(ev_dir, "fn_audit.json"), "w") as f:
        json.dump(audit, f, indent=1)
    cats: Dict[str, int] = {}
    for r in audit:
        cats[r["category"]] = cats.get(r["category"], 0) + 1
    log_fn(
        f"hybrid: all-F1 {model_metrics['all']['f1']:.4f} "
        f"(snp {model_metrics['snp']['f1']:.4f} / indel "
        f"{model_metrics['indel']['f1']:.4f}); oracle "
        f"{oracle_metrics['all']['f1']:.4f}; fn audit {cats}"
    )
    return {
        "region": region,
        "model": model_metrics,
        "oracle": oracle_metrics,
        "fn_audit_categories": cats,
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser("accuracy_hybrid")
    p.add_argument("--workdir", required=True)
    p.add_argument("--stages", default="gen,train,eval")
    p.add_argument("--seeds", default="701,702")
    p.add_argument("--eval_seed", type=int, default=90777)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--num_epochs", type=int, default=30)
    p.add_argument("--learning_rate", type=float, default=0.004)
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
        counts = generate_corpus(args.workdir, seeds, args.num_workers)
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
            args.learning_rate, device,
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
