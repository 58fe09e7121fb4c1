"""Scaled long-read accuracy: synthetic PacBio/ONT corpus -> real eval.

The round-2 long-read accuracy artifact (scripts/accuracy_ont.py)
trained on the ~70 real labeled examples the 25 kb HG002 R10 window
yields — enough to prove the pipeline but not the model (one fold had
a single het training example; indel F1 was 0.0 for want of indel
training data). This driver closes that data gap for BOTH long-read
families with the fitted long-read simulator
(training/simulate_longread.py):

  1. simulate diploid long reads over megabases of the GRCh38 chr20
     reference slice (error model fitted to the family's real
     template run: read lengths, quality strings, indel event rates,
     homopolymer systematics),
  2. label them through `make_examples --mode training` with the
     family's production preset (PACBIO / ONT_R104: phased
     haplotype-sorted pileups, diff_channels alt alignment, no
     realigner),
  3. train InceptionV3 with the device-resident loop,
  4. evaluate on the REAL family BAM against the NIST/GIAB HG002
     v4.2.1 truth inside its shipped confident regions (hap.py
     semantics) — training never sees a real TRUTH RECORD; note the
     error model IS fitted on the template BAM's reads (the ONT
     template region equals the eval span, the PacBio template region
     contains it, and template quality strings are resampled verbatim
     into training reads), so the eval is independent of truth labels
     but not of the template run's error statistics,
  5. quote the oracle-labeling ceiling beside the model F1.

Eval data:
  * ONT — REAL DATA: HG002_R10_chr20_5050000_5075000.bam (R10.4)
    on the masked GRCh38 FASTA vs the HG002 v4.2.1 truth, scored over
    chr20:5,050,000-5,075,000 — a valid (reads, truth) pairing.
  * PACBIO — SIMULATED HELD-OUT: the only HiFi BAM in this image
    (test_pacbio.chr20_100kbp_at_9mb.bam) is **HG003** (@RG SM:HG003;
    confirmed by read evidence) and no HG003 truth ships here, so a
    real-data PacBio eval with a matching truth is impossible; the
    family instead evaluates on freshly simulated windows disjoint
    from training (exact known truth), fitted to the HG003 template's
    error profile. Round 3's PacBio directive assumed the HG002
    pairing was valid — it was not.

The port's copy of the JAX package's driver (stages, flags, constants,
checkpoint names and JSON keys kept); training and call_variants run
on `--device` (default `cuda`, which raises without a card; `cpu` runs
float32).

Reference anchors: PacBio/ONT case studies (docs/metrics.md:37-40),
training case study (docs/deepvariant-training-case-study.md),
run_oracle_inference.py (oracle ceiling semantics).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from deepvariant_tpu_torch.device import resolve_device
from deepvariant_tpu_torch.scripts.accuracy_sim import (
    _merge_tfrecords,
    _run_make_examples_fanout,
    call_checkpoint,
    train_precision,
)

TESTDATA = "/root/reference/deepvariant/testdata/input"
TRIO_TESTDATA = "/root/reference/deeptrio/testdata/input"
GRCH38_10M = f"{TESTDATA}/grch38.chr20_and_21_10M.fa.gz"
V421_TRUTH = (
    f"{TRIO_TESTDATA}/HG002_GRCh38_1_22_v4.2.1_benchmark.chr20.vcf.gz"
)
V421_BED = f"{TRIO_TESTDATA}/HG002_GRCh38_1_22_v4.2.1_benchmark.chr20.bed"

# Simulation windows on the grch38 chr20 0-10 Mb slice (non-N from
# 66 kb). Both eval regions — chr20:5.05-5.075M (ONT) and
# chr20:9.0-9.1M (PacBio) — are excluded with wide margins so no
# family's training simulation touches any eval sequence context.
_TRAIN_WINDOWS = [
    (200_000, 500_000),
    (700_000, 1_000_000),
    (1_200_000, 1_500_000),
    (1_700_000, 2_000_000),
    (2_200_000, 2_500_000),
    (2_700_000, 3_000_000),
    (3_200_000, 3_500_000),
    (3_700_000, 4_000_000),
]
_TUNE_WINDOWS = [(4_200_000, 4_350_000)]

FAMILIES: Dict[str, dict] = {
    "pacbio": {
        "preset": "PACBIO",
        "train_config": "pacbio",
        "coverage": 0.0,  # 0 = fitted from the template BAM
        "template_bam": f"{TESTDATA}/test_pacbio.chr20_100kbp_at_9mb.bam",
        "template_region": ("chr20", 8_980_000, 9_100_000),
        "template_ref": GRCH38_10M,
        # ROUND-4 FINDING: test_pacbio.chr20_100kbp_at_9mb.bam is
        # **HG003** (@RG SM:HG003, pbmm2 --sample HG003; confirmed by
        # read evidence: sites the HG002 truth calls het show 100% alt
        # reads and vice versa), and NO HG003 truth set ships in this
        # image — so a real-data PacBio accuracy eval with a matching
        # truth is IMPOSSIBLE here. The pacbio family therefore
        # evaluates on SIMULATED held-out windows (disjoint from
        # training, fresh seed, exact known truth) fitted to the HG003
        # template's error profile. The ONT family's pairing
        # (HG002_R10 reads vs the HG002 v4.2.1 truth) is valid and
        # stays a real-data eval.
        "eval": {
            "simulated": True,
            "ref": GRCH38_10M,
            "windows": [(4_500_000, 4_650_000)],
            "region": "chr20:4,500,000-4,650,000",
            "span": (4_500_000, 4_650_000),
            "seed": 90210,
            "sample": "SIM",
        },
    },
    "ont": {
        "preset": "ONT_R104",
        "train_config": "ont",
        "coverage": 0.0,  # 0 = fitted from the template BAM
        "template_bam": (
            f"{TRIO_TESTDATA}/HG002_R10_chr20_5050000_5075000.bam"
        ),
        "template_region": ("chr20", 5_050_000, 5_075_000),
        "template_ref": (
            f"{TRIO_TESTDATA}/grch38.chr20_5050000_5075000.masked.fa.gz"
        ),
        "eval": {
            "reads": (
                f"{TRIO_TESTDATA}/HG002_R10_chr20_5050000_5075000.bam"
            ),
            "ref": (
                f"{TRIO_TESTDATA}/"
                "grch38.chr20_5050000_5075000.masked.fa.gz"
            ),
            "region": "chr20:5,050,000-5,075,000",
            "span": (5_050_000, 5_075_000),
            "truth": V421_TRUTH,
            "confident_bed": V421_BED,
            "sample": "HG002",
        },
    },
}


def _chunk_windows(
    contig: str, windows: Sequence[Tuple[int, int]], chunk: int
) -> List[str]:
    out = []
    for lo, hi in windows:
        for s in range(lo, hi, chunk):
            out.append(f"{contig}:{s}-{min(s + chunk, hi)}")
    return out


def resolve_channels(
    family: str, extra_channels_csv: str
) -> Optional[List[int]]:
    """Preset channels + appended extras (the homopolymer-family
    ablation, round-5 directive #6: enums 16/17/28/29/30 exist and
    are bit-exact in pileup.py but no preset uses them for ONT —
    reference homopolymer_weighted_channel.cc). Returns the full
    channel list to override with, or None for the preset default."""
    if not extra_channels_csv:
        return None
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.presets import apply_model_preset

    probe = MakeExamplesOptions(
        reads_filename="", ref_filename="", examples_filename="",
    )
    apply_model_preset(probe, FAMILIES[family]["preset"])
    base = list(probe.pileup_options.channels)
    for tok in extra_channels_csv.split(","):
        ch = int(tok)
        if ch not in base:
            base.append(ch)
    return base


def generate_corpus(
    workdir: str,
    family: str,
    seeds: Sequence[int],
    coverage: Optional[float],
    num_workers: int,
    extra_channels: Optional[List[int]] = None,
    truth_indel_rate: Optional[float] = None,
    log_fn=print,
) -> Dict[str, int]:
    from deepvariant_tpu_torch.training.simulate_longread import (
        LongReadSimConfig,
        simulate_corpus_longread,
    )

    spec = FAMILIES[family]
    cov = coverage if coverage is not None else spec["coverage"]
    rate_kw = (
        {"indel_rate": truth_indel_rate} if truth_indel_rate else {}
    )

    def _sim(windows, seed, outdir):
        return simulate_corpus_longread(LongReadSimConfig(
            ref_path=GRCH38_10M, contig="chr20", windows=windows,
            template_bam=spec["template_bam"],
            template_region=spec["template_region"],
            template_ref_path=spec["template_ref"],
            seed=seed, coverage=cov, **rate_kw,
        ), outdir)

    def _label(sim, windows, outdir, tag) -> List[str]:
        jobs, parts = [], []
        for i, region in enumerate(
            _chunk_windows("chr20", windows, 75_000)
        ):
            part = os.path.join(outdir, f"{tag}{i:03d}.tfrecord.gz")
            job = dict(
                reads_filename=sim["bam"], ref_filename=GRCH38_10M,
                examples_filename=part, mode="training",
                regions=[region],
                truth_variants_filename=sim["truth_vcf"],
                confident_regions_filename=sim["confident_bed"],
                model_preset=spec["preset"],
            )
            if extra_channels:
                job["channels_override"] = extra_channels
            jobs.append(job)
            parts.append(part)
        _run_make_examples_fanout(jobs, num_workers,
                                  log_fn=lambda _: None)
        return parts

    train_parts: List[str] = []
    for seed in seeds:
        rep_dir = os.path.join(workdir, f"rep{seed}")
        t0 = time.time()
        sim = _sim(_TRAIN_WINDOWS, seed, rep_dir)
        log_fn(f"rep{seed}: {sim['n_variants']} variants, "
               f"{sim['n_reads']} reads in {time.time() - t0:.0f}s")
        t0 = time.time()
        train_parts += _label(sim, _TRAIN_WINDOWS, rep_dir, "part")
        log_fn(f"rep{seed}: labeled in {time.time() - t0:.0f}s")

    tune_dir = os.path.join(workdir, "tune_sim")
    tune_sim = _sim(_TUNE_WINDOWS, max(seeds) + 7919, tune_dir)
    tune_parts = _label(tune_sim, _TUNE_WINDOWS, tune_dir, "tune")

    train_path = os.path.join(workdir, "train.tfrecord.gz")
    tune_path = os.path.join(workdir, "tune.tfrecord.gz")
    counts = {
        "train": _merge_tfrecords(train_parts, train_path),
        "tune": _merge_tfrecords(tune_parts, tune_path),
    }
    log_fn(f"corpus: {counts['train']} train / {counts['tune']} tune")

    from deepvariant_tpu_torch.training.data import DatasetConfig

    DatasetConfig(
        name=f"{family}-sim-train", tfrecord_path=train_path,
        num_examples=counts["train"],
    ).write(os.path.join(workdir, "train_dataset.json"))
    DatasetConfig(
        name=f"{family}-sim-tune", tfrecord_path=tune_path,
        num_examples=counts["tune"],
    ).write(os.path.join(workdir, "tune_dataset.json"))
    return counts


def train_model(
    workdir: str,
    family: str,
    batch_size: int,
    num_epochs: int,
    learning_rate: float,
    device: str,
    class_weights: str,
    log_fn=print,
) -> str:
    from deepvariant_tpu_torch.training.config import get_config
    from deepvariant_tpu_torch.training.train_resident import train_resident

    config = get_config(FAMILIES[family]["train_config"])
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
    # The production long-read class_weights (1,1,10) are tuned for
    # GIAB-scale corpora; "auto" keeps them, anything else overrides
    # (accuracy_ont measured 1,1,10 collapsing tiny corpora).
    if class_weights != "auto":
        config.class_weights = class_weights

    device = train_precision(config, device)
    exp_dir = os.path.join(workdir, "experiment")
    results = train_resident(config, exp_dir, device=device,
                             log_fn=log_fn)
    log_fn(f"training done: best tune/f1_weighted="
           f"{results.get('best_metric', 0):.4f} "
           f"at epoch {results.get('best_epoch')}")
    return os.path.join(exp_dir, "checkpoints", "best.msgpack")


def evaluate_model(
    workdir: str,
    family: str,
    ckpt: str,
    batch_size: int,
    extra_channels: Optional[List[int]] = None,
    sim_windows: Optional[List[Tuple[int, int]]] = None,
    sim_seed: int = 0,
    eval_tag: str = "eval",
    log_fn=print,
    device="cuda",
) -> Dict[str, object]:
    from deepvariant_tpu_torch.io.fasta import FastaReader
    from deepvariant_tpu_torch.labeler import labeled_examples_to_vcf
    from deepvariant_tpu_torch.postprocess.pipeline import postprocess_variants
    from deepvariant_tpu_torch.tools import vcf_eval

    spec = FAMILIES[family]
    ev = dict(spec["eval"])
    if sim_windows:
        # CI-powered held-out simulated eval over caller-chosen spans
        # (round-5 directive #2): overrides the family default.
        lo, hi = sim_windows[0][0], sim_windows[-1][1]
        ev = {
            "simulated": True,
            "ref": GRCH38_10M,
            "windows": list(sim_windows),
            "region": f"chr20:{lo}-{hi}",
            "span": (lo, hi),
            "seed": sim_seed or 91000,
            "sample": "SIM",
        }
    ev_dir = os.path.join(workdir, eval_tag)
    os.makedirs(ev_dir, exist_ok=True)
    if ev.get("simulated"):
        # Held-out simulated eval (see the pacbio FAMILIES note):
        # fresh seed, windows disjoint from every training window,
        # error model fitted to the same template run.
        from deepvariant_tpu_torch.training.simulate_longread import (
            LongReadSimConfig,
            simulate_corpus_longread,
        )

        sim_dir = os.path.join(ev_dir, "sim")
        sim = simulate_corpus_longread(LongReadSimConfig(
            ref_path=ev["ref"], contig="chr20",
            windows=ev["windows"],
            template_bam=spec["template_bam"],
            template_region=spec["template_region"],
            template_ref_path=spec["template_ref"],
            seed=ev["seed"], coverage=spec["coverage"],
        ), sim_dir)
        ev["reads"] = sim["bam"]
        ev["truth"] = sim["truth_vcf"]
        ev["confident_bed"] = sim["confident_bed"]
    lo, hi = ev["span"]
    span_bed = os.path.join(ev_dir, "span.bed")
    with open(span_bed, "w") as f:
        f.write(f"chr20\t{lo}\t{hi}\n")

    calling_path = os.path.join(ev_dir, "calling.tfrecord.gz")
    oracle_path = os.path.join(ev_dir, "oracle.tfrecord.gz")
    # Chunk the eval span so a Mbp-scale powered eval parallelizes
    # the same way the labeling fan-out does.
    eval_windows = ev.get("windows") or [ev["span"]]
    jobs, calling_parts, oracle_parts = [], [], []
    for i, region in enumerate(
        _chunk_windows("chr20", eval_windows, 75_000)
    ):
        cp = os.path.join(ev_dir, f"calling{i:03d}.tfrecord.gz")
        op = os.path.join(ev_dir, f"oracle{i:03d}.tfrecord.gz")
        cjob = dict(
            reads_filename=ev["reads"], ref_filename=ev["ref"],
            examples_filename=cp, mode="calling",
            regions=[region], model_preset=spec["preset"],
        )
        ojob = dict(
            reads_filename=ev["reads"], ref_filename=ev["ref"],
            examples_filename=op, mode="training",
            regions=[region], model_preset=spec["preset"],
            truth_variants_filename=ev["truth"],
            confident_regions_filename=ev["confident_bed"],
        )
        if extra_channels:
            cjob["channels_override"] = extra_channels
            ojob["channels_override"] = extra_channels
        jobs += [cjob, ojob]
        calling_parts.append(cp)
        oracle_parts.append(op)
    _run_make_examples_fanout(jobs, 4, log_fn=lambda _: None)
    _merge_tfrecords(calling_parts, calling_path)
    _merge_tfrecords(oracle_parts, oracle_path)

    cvo_path = os.path.join(ev_dir, "cvo.tfrecord.gz")
    call_checkpoint(ckpt, calling_path, cvo_path, batch_size, device)
    vcf_out = os.path.join(ev_dir, "out.vcf.gz")
    postprocess_variants(
        cvo_path, vcf_out, FastaReader(ev["ref"]).contigs,
        sample_name=ev["sample"],
    )
    # hap.py semantics: scored inside the truth set's shipped
    # confident regions (docs/metrics.md:33-44).
    confident = vcf_eval.evaluate(
        ev["truth"], vcf_out,
        confident_bed=ev["confident_bed"], region=ev["region"],
    )
    full = vcf_eval.evaluate(
        ev["truth"], vcf_out, confident_bed=span_bed,
        region=ev["region"],
    )
    oracle_vcf = os.path.join(ev_dir, "oracle.vcf.gz")
    labeled_examples_to_vcf.run(
        oracle_path, ev["ref"], oracle_vcf, sample_name=ev["sample"],
    )
    oracle = vcf_eval.evaluate(
        ev["truth"], oracle_vcf,
        confident_bed=ev["confident_bed"], region=ev["region"],
    )
    # Confident-region FN diagnosis (tools/fn_audit.py): candidate
    # miss vs CNN miss vs genotype error, persisted beside the eval.
    from deepvariant_tpu_torch.tools import fn_audit

    audit = fn_audit.run(
        ev["truth"], vcf_out, cvo_path,
        confident_bed=ev["confident_bed"], region=ev["region"],
    )
    with open(os.path.join(ev_dir, "fn_audit.json"), "w") as f:
        json.dump(audit, f, indent=1)
    log_fn(
        f"{family}: confident-regions F1 snp "
        f"{confident['snp']['f1']:.4f} / indel "
        f"{confident['indel']['f1']:.4f} / all "
        f"{confident['all']['f1']:.4f}; oracle ceiling all "
        f"{oracle['all']['f1']:.4f}"
    )
    return {
        "family": family,
        "region": ev["region"],
        "model_confident": confident,
        "model_full_span": full,
        "oracle_confident": oracle,
        "fn_audit": audit,
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", required=True)
    p.add_argument("--family", choices=("pacbio", "ont"),
                   required=True)
    p.add_argument("--stages", default="gen,train,eval")
    p.add_argument("--seeds", default="101")
    p.add_argument("--coverage", type=float, default=0.0)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=192)
    p.add_argument("--num_epochs", type=int, default=30)
    p.add_argument("--learning_rate", type=float, default=0.004)
    p.add_argument("--class_weights", default="auto",
                   help="'auto' keeps the family preset; or e.g. '' "
                        "(uniform) / '1,1,3'")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where training and call_variants run; cuda "
                        "raises without a card")
    p.add_argument("--select", choices=("final", "best"),
                   default="final",
                   help="which checkpoint to eval: the converged final "
                        "epoch (default — the tiny simulated tune set "
                        "saturates within a few epochs, so best-by-"
                        "tune picks an undertrained model; measured: "
                        "ONT best-at-epoch-4 scored all-F1 0.28 where "
                        "final scored far higher) or the tune-best")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--report", default="")
    p.add_argument("--extra_channels", default="",
                   help="comma enums appended to the preset channel "
                        "set for training AND eval (homopolymer "
                        "ablation: 16,17,28,29,30)")
    p.add_argument("--sim_eval_windows", default="",
                   help="lo-hi[,lo-hi] chr20 spans: run an EXTRA "
                        "held-out simulated eval at this scale "
                        "(stage name simeval)")
    p.add_argument("--sim_eval_seed", type=int, default=91000)
    p.add_argument("--truth_indel_rate", type=float, default=0.0,
                   help="override the TRAINING corpus truth indel "
                        "rate (simulate_longread default 1/1400; "
                        "most indels land in repeat tracts via "
                        "indel_repeat_fraction) — the ONT "
                        "homopolymer-indel enrichment knob")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    stages = set(args.stages.split(","))
    os.makedirs(args.workdir, exist_ok=True)
    extra_channels = resolve_channels(args.family, args.extra_channels)
    result: Dict[str, object] = {"family": args.family}
    if extra_channels:
        result["channels_override"] = extra_channels
    if "gen" in stages:
        result["corpus"] = generate_corpus(
            args.workdir, args.family,
            [int(s) for s in args.seeds.split(",")],
            args.coverage or None, args.num_workers,
            extra_channels=extra_channels,
            truth_indel_rate=args.truth_indel_rate or None,
        )
    ckpt = args.checkpoint or os.path.join(
        args.workdir, "experiment", "checkpoints",
        f"{args.select}.msgpack",
    )
    if "train" in stages:
        train_model(
            args.workdir, args.family, args.batch_size,
            args.num_epochs, args.learning_rate, device,
            args.class_weights,
        )
    if "eval" in stages:
        result["eval"] = evaluate_model(
            args.workdir, args.family, ckpt, args.batch_size,
            extra_channels=extra_channels, device=device,
        )
    if "simeval" in stages and args.sim_eval_windows:
        windows = [
            tuple(int(x) for x in tok.split("-"))
            for tok in args.sim_eval_windows.split(",")
        ]
        result["sim_eval"] = evaluate_model(
            args.workdir, args.family, ckpt, args.batch_size,
            extra_channels=extra_channels,
            sim_windows=windows, sim_seed=args.sim_eval_seed,
            eval_tag="sim_eval", device=device,
        )
    report = args.report or os.path.join(args.workdir, "report.json")
    with open(report, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(
        {k: v for k, v in result.items() if k != "corpus"} |
        {"corpus": result.get("corpus")}
    ))


if __name__ == "__main__":
    main()
