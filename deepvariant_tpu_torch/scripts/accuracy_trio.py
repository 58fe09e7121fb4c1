"""DeepTrio accuracy at training scale: simulated families, measured
child F1 + de-novo recall.

The real trio data in this image covers 10 kb (~1.5k reads/sample —
enough for the cross-fold capability proof in accuracy_deeptrio.py,
not for a trained-model accuracy claim). This driver instead uses the
family simulator (training/simulate_family.py):

  1. simulate N family replicates over megabases of GRCh38 chr20:
     population loci shared between parents by allele frequency,
     mendelian child inheritance with crossovers, de novos injected
     at a documented ELEVATED rate so recall is measurable;
  2. label the CHILD's candidates through the production DeepTrio
     stacked-pileup path (make_examples/multisample.py: [parent1,
     child, parent2] x 100 rows -> 300-row examples, child truth —
     deeptrio/make_examples.py:48 sample ordering);
  3. train InceptionV3 on the 300-row examples with the
     device-resident loop;
  4. evaluate HELD-OUT freshly-seeded family replicates over spans
     disjoint from every training window, through the full calling
     pipeline (trio make_examples -> CNN -> postprocess), scored
     against the child truth with Wilson 95% CIs; de-novo recall is
     scored against the de-novo subset, and the oracle-labeling
     ceiling is quoted beside the model.

The port's copy of the JAX package's driver (stages, flags, constants,
checkpoint names and JSON keys kept); training and call_variants run
on `--device` (default `cuda`, which raises without a card; `cpu` runs
float32).

Reference anchors: deeptrio/make_examples.py (product),
docs/deeptrio-case-study.md (published child accuracy),
run_oracle_inference.py (ceiling semantics).

GRCh38 chr20 span allocation (this repo's sim corpora; spans held
disjoint WITHIN each product's train/eval split):
  trio train 0.2-2.0M | trio tune 4.2-4.35M | trio eval 2.2-4.0M.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from deepvariant_tpu_torch.device import resolve_device

TESTDATA = "/root/reference/deepvariant/testdata/input"
GRCH38_10M = f"{TESTDATA}/grch38.chr20_and_21_10M.fa.gz"
CONTIG = "chr20"

TRAIN_WINDOWS = [(200_000, 1_100_000), (1_100_000, 2_000_000)]
TUNE_WINDOWS = [(4_200_000, 4_350_000)]
EVAL_WINDOWS = [(2_200_000, 3_100_000), (3_100_000, 4_000_000)]

# Documented-elevated de-novo rate for eval power (~70 de novos over
# the 1.8 Mbp eval span; the real rate ~1.2e-8/bp would give ~0.02).
DE_NOVO_SNV_RATE = 1.0 / 25_000.0
DE_NOVO_INDEL_RATE = 1.0 / 125_000.0

_CHUNK = 64_000


def _worker_env() -> dict:
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return env


# One multi-sample make_examples job, given as JSON in argv[1]. Host
# only: the workers import the port and never touch the card.
_MULTI_WORKER_CODE = (
    "import json,sys\n"
    "from deepvariant_tpu_torch.make_examples.core import "
    "MakeExamplesOptions\n"
    "from deepvariant_tpu_torch.make_examples.multisample import ("
    "make_multisample_examples_runner, trio_samples, somatic_samples)\n"
    "kw = json.loads(sys.argv[1])\n"
    "kind = kw.pop('kind')\n"
    "sample_kw = kw.pop('samples')\n"
    "if kind == 'trio':\n"
    "    samples = trio_samples(**sample_kw)\n"
    "else:\n"
    "    samples = somatic_samples(**sample_kw)\n"
    "opts = MakeExamplesOptions(**kw)\n"
    "print(json.dumps(make_multisample_examples_runner("
    "opts, samples, 1)))\n"
)


def run_multisample_fanout(
    jobs: List[dict], num_workers: int, log_fn=print
) -> None:
    """Multi-sample analogue of accuracy_sim._run_make_examples_fanout
    (same halt-on-first-failure subprocess semantics)."""
    pending = list(jobs)
    running: List[Tuple[subprocess.Popen, dict]] = []
    env = _worker_env()
    while pending or running:
        while pending and len(running) < num_workers:
            job = pending.pop(0)
            proc = subprocess.Popen(
                [sys.executable, "-c", _MULTI_WORKER_CODE,
                 json.dumps(job)],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )
            running.append((proc, job))
        done = [(p, j) for p, j in running if p.poll() is not None]
        running = [(p, j) for p, j in running if p.poll() is None]
        for proc, job in done:
            out, err = proc.communicate()
            if proc.returncode != 0:
                for p, _ in running:
                    p.kill()
                raise RuntimeError(
                    f"multisample make_examples failed for "
                    f"{job.get('regions')}:\n{err}"
                )
            log_fn(f"  {job.get('regions')}: {out.strip()}")
        if running:
            time.sleep(0.3)


def _chunk_regions(
    windows: Sequence[Tuple[int, int]]
) -> List[str]:
    out = []
    for lo, hi in windows:
        for s in range(lo, hi, _CHUNK):
            out.append(f"{CONTIG}:{s}-{min(s + _CHUNK, hi)}")
    return out


def _trio_jobs(
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
            kind="trio",
            samples=dict(
                reads_child=sim["bam_child"],
                reads_parent1=sim["bam_parent1"],
                reads_parent2=sim["bam_parent2"],
                sample_name_child="child",
            ),
            reads_filename=sim["bam_child"],
            ref_filename=GRCH38_10M,
            examples_filename=part,
            mode=mode,
            regions=[region],
            realigner_enabled=True,
            sample_name="child",
        )
        if mode == "training":
            job.update(
                truth_variants_filename=sim["truth_child"],
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
        TrioSimConfig,
        simulate_trio_corpus,
    )

    t0 = time.time()
    sim = simulate_trio_corpus(TrioSimConfig(
        ref_path=GRCH38_10M, contig=CONTIG, windows=windows,
        seed=seed,
        de_novo_snv_rate=DE_NOVO_SNV_RATE,
        de_novo_indel_rate=DE_NOVO_INDEL_RATE,
        **accuracy_sim.DEFAULT_TEMPLATE,
    ), outdir)
    log_fn(
        f"trio sim seed {seed}: {sim['n_child_variants']} child "
        f"variants ({sim['n_denovo']} de novo), {sim['n_reads']} "
        f"reads in {time.time() - t0:.0f}s"
    )
    return sim


def _merge_tfrecords_capped(
    parts: List[str], merged: str, cap: Optional[int]
) -> int:
    """Merge with an even-stride thinning cap: a 300-row trio corpus
    is 3x the bytes of a single-sample one, and the device-resident
    trainer ships the whole tensor to device memory
    (train_resident.py)."""
    from deepvariant_tpu_torch.io import tfrecord
    from deepvariant_tpu_torch.scripts.accuracy_sim import _merge_tfrecords

    if not cap:
        return _merge_tfrecords(parts, merged)
    import numpy as np
    import shutil

    total = 0
    for part in parts:
        if os.path.exists(part):
            total += sum(1 for _ in tfrecord.read_tfrecords(part))
    if total <= cap:
        return _merge_tfrecords(parts, merged)
    keep = set(np.linspace(0, total - 1, cap).astype(int).tolist())
    n = i = 0
    with tfrecord.TFRecordWriter(merged) as w:
        for part in parts:
            if not os.path.exists(part):
                continue
            for rec in tfrecord.read_tfrecords(part):
                if i in keep:
                    w.write(rec)
                    n += 1
                i += 1
    for part in parts:
        info = part + ".example_info.json"
        if os.path.exists(info):
            shutil.copyfile(info, merged + ".example_info.json")
            break
    return n


def generate_corpus(
    workdir: str, seeds: Sequence[int], num_workers: int,
    train_cap: Optional[int] = 10_000, log_fn=print
) -> Dict[str, int]:
    from deepvariant_tpu_torch.scripts.accuracy_sim import _merge_tfrecords
    from deepvariant_tpu_torch.training.data import DatasetConfig

    train_parts: List[str] = []
    for seed in seeds:
        rep_dir = os.path.join(workdir, f"rep{seed}")
        sim = simulate_replicate(rep_dir, TRAIN_WINDOWS, seed, log_fn)
        t0 = time.time()
        jobs, parts = _trio_jobs(
            sim, TRAIN_WINDOWS, rep_dir, "training", "part"
        )
        run_multisample_fanout(jobs, num_workers, log_fn=lambda _: None)
        log_fn(f"rep{seed}: labeled in {time.time() - t0:.0f}s")
        train_parts += parts

    tune_dir = os.path.join(workdir, "tune_sim")
    tune_sim = simulate_replicate(
        tune_dir, TUNE_WINDOWS, max(seeds) + 7919, log_fn
    )
    tune_jobs, tune_parts = _trio_jobs(
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
        name="trio-sim-train", tfrecord_path=train_path,
        num_examples=counts["train"],
    ).write(os.path.join(workdir, "train_dataset.json"))
    DatasetConfig(
        name="trio-sim-tune", tfrecord_path=tune_path,
        num_examples=counts["tune"],
    ).write(os.path.join(workdir, "tune_dataset.json"))
    return counts


def train_model(
    workdir: str,
    batch_size: int,
    num_epochs: int,
    learning_rate: float,
    device: str,
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
    from deepvariant_tpu_torch.labeler import labeled_examples_to_vcf
    from deepvariant_tpu_torch.postprocess.pipeline import postprocess_variants
    from deepvariant_tpu_torch.scripts.accuracy_sim import call_checkpoint
    from deepvariant_tpu_torch.tools import fn_audit, vcf_eval

    ev_dir = os.path.join(workdir, "eval")
    os.makedirs(ev_dir, exist_ok=True)
    sim = simulate_replicate(
        os.path.join(ev_dir, "sim"), EVAL_WINDOWS, eval_seed, log_fn
    )

    calling_jobs, calling_parts = _trio_jobs(
        sim, EVAL_WINDOWS, ev_dir, "calling", "calling"
    )
    oracle_jobs, oracle_parts = _trio_jobs(
        sim, EVAL_WINDOWS, ev_dir, "training", "oracle"
    )
    t0 = time.time()
    run_multisample_fanout(
        calling_jobs + oracle_jobs, num_workers, log_fn=lambda _: None
    )
    log_fn(f"eval stage-1 in {time.time() - t0:.0f}s")

    from deepvariant_tpu_torch.scripts.accuracy_sim import _merge_tfrecords

    calling_path = os.path.join(ev_dir, "calling.tfrecord.gz")
    oracle_path = os.path.join(ev_dir, "oracle.tfrecord.gz")
    _merge_tfrecords(calling_parts, calling_path)
    _merge_tfrecords(oracle_parts, oracle_path)

    cvo_path = os.path.join(ev_dir, "cvo.tfrecord.gz")
    call_checkpoint(ckpt, calling_path, cvo_path, batch_size, device)
    vcf_out = os.path.join(ev_dir, "child.vcf.gz")
    postprocess_variants(
        cvo_path, vcf_out, FastaReader(GRCH38_10M).contigs,
        sample_name="child",
    )

    region = (
        f"{CONTIG}:{EVAL_WINDOWS[0][0]}-{EVAL_WINDOWS[-1][1]}"
    )
    model_metrics = vcf_eval.evaluate(
        sim["truth_child"], vcf_out,
        confident_bed=sim["confident_bed"], region=region,
    )
    # De-novo recall: the de-novo truth subset scored the same way
    # (precision vs this subset is meaningless — inherited calls are
    # correct calls — so only recall is reported).
    denovo_metrics = vcf_eval.evaluate(
        sim["truth_denovo"], vcf_out,
        confident_bed=sim["confident_bed"], region=region,
    )
    oracle_vcf = os.path.join(ev_dir, "oracle.vcf.gz")
    labeled_examples_to_vcf.run(
        oracle_path, GRCH38_10M, oracle_vcf, sample_name="child",
    )
    oracle_metrics = vcf_eval.evaluate(
        sim["truth_child"], oracle_vcf,
        confident_bed=sim["confident_bed"], region=region,
    )
    audit = fn_audit.run(
        sim["truth_child"], vcf_out, cvo_path,
        confident_bed=sim["confident_bed"], region=region,
    )
    with open(os.path.join(ev_dir, "fn_audit.json"), "w") as f:
        json.dump(audit, f, indent=1)

    log_fn(
        f"trio child: all-F1 {model_metrics['all']['f1']:.4f} "
        f"(snp {model_metrics['snp']['f1']:.4f} / indel "
        f"{model_metrics['indel']['f1']:.4f}); de-novo recall "
        f"{denovo_metrics['all']['recall']:.4f} "
        f"({denovo_metrics['all']['tp']}/"
        f"{denovo_metrics['all']['n_truth']}); oracle all-F1 "
        f"{oracle_metrics['all']['f1']:.4f}"
    )
    return {
        "region": region,
        "model": model_metrics,
        "denovo": {
            "recall": denovo_metrics["all"]["recall"],
            "recall_ci95": denovo_metrics["all"]["recall_ci95"],
            "tp": denovo_metrics["all"]["tp"],
            "n_truth": denovo_metrics["all"]["n_truth"],
            "snp": denovo_metrics["snp"],
            "indel": denovo_metrics["indel"],
        },
        "oracle": oracle_metrics,
        "fn_audit_categories": _audit_categories(audit),
    }


def _audit_categories(audit: List[dict]) -> Dict[str, int]:
    cats: Dict[str, int] = {}
    for r in audit:
        cats[r["category"]] = cats.get(r["category"], 0) + 1
    return cats


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser("accuracy_trio")
    p.add_argument("--workdir", required=True)
    p.add_argument("--stages", default="gen,train,eval")
    p.add_argument("--seeds", default="501,502")
    p.add_argument("--eval_seed", type=int, default=90555)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=96)
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
