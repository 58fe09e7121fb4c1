#!/usr/bin/env python3
"""Drive the PyTorch port (deepvariant_tpu_torch) on one CUDA card and
check what comes out.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases:
  1. Build every CUDA kernel from csrc/ (one nvcc each, in parallel) and
     print the build time and the compiler's register report.
  2. Hold each kernel against its plain PyTorch version on the card,
     bit-exact: both entry points of the paint kernel (rows form and
     plan form) at the WGS path's shape and at two shapes whose tiles
     start and end off row and candidate boundaries, and the plan form
     at the long-read shape (512x95x147, 8 channels and the two diff
     planes), at 12 planes and at an odd shape with a shuffled channel
     order and non-default colors; on plans with tlen -2**31, support
     codes outside 0..2, hp outside 0..2 and alt_present in all four
     combinations. Time the forms and their plain versions with CUDA
     events at the WGS and long-read shapes, and check that one painter
     call is one kernel: the wrapper counts one launch and the allocator
     one tensor (the output, no temporary), and where torch.profiler
     delivers device records, they name the paint kernel and nothing
     else. Then the training batch norm + ReLU kernels
     (`phase_batch_norm_relu`) at batch 2,048 (bfloat16) at every
     distinct layer shape of each preset's 94: their output, running
     statistics and gradients against the plain version, and forward +
     backward timed for the three largest layers and the sum over all
     94, beside the 16-byte-an-element bound, the plain version and
     torch's own batch_norm + relu (`library_ms`, which the port never
     calls). Their launches are counted on the train step in phase 14.
     Then the pool kernels (`phase_pool`): every distinct pool shape of
     both presets at batch 2,048 (the 3x3 box filter and the 3x3
     stride-2 max pool, 13 pools a pass), forward and backward held bit
     for bit to torch's own CUDA pools (the plain version: the code
     before the kernels) in bfloat16 and float32, run twice (bit-equal),
     and timed in bfloat16 beside the byte floor (each pool's input and
     output once each way), the plain version and torch's library call.
     Phase 14 counts their launches on the train step: 13 forward and 13
     backward a micro-batch.
  3. Staged call_variants: write synthetic 100x221x7 WGS examples and a
     seeded checkpoint with the port's own writers, run the CLI
     (`deepvariant_tpu_torch.scripts.call_variants.main`) on the card at
     batch 512 with the default writer processes, and check the CVOs.
  4. The fused plan path: PlanPredictor over synthetic WGS plans at batch
     512, through the CUDA paint kernel.
  5. The long-read fused plan path at full width: PlanPredictor with the
     PACBIO pileup preset (100x147, 8 channels + diff_channels = 10
     planes), InceptionV3(10) with seeded weights, batch 512, bfloat16,
     over plans that carry the alt tensors.
  6. The region-gather encoder: encode_region_candidates over synthetic
     reads on the card equals the same call on the CPU.
  7. Stage 1 from files through the stream path, at the full width of
     the WGS model (100x221x7, InceptionV3(7), bfloat16, batch 512):
     write a seeded FASTA and an indexed BAM with the port's own
     writers, run `make_examples_runner` with a plan sink in this
     process and keep the plans, then run
     `stream_examples_to_cvos(device_encode=True)` with two spawned
     workers feeding the card. As many CVOs as plans; the same variants
     and alt indices; probabilities equal to PlanPredictor on the kept
     plans; the first batch's fused images bit-identical to the plain
     painter; one launch of the plan form per batch. Prints the reads
     decoded per second, one worker's candidates and plans per second,
     and the whole path's examples per second. The realigner is switched
     off here (`realigner_enabled=False`): this is the point phase 8 is
     compared with.
  8. The WGS preset with its defaults, realigner on, from files to a VCF:
     a seeded sample with a variant every 400-500 bases, so that the
     window selector's windows stay under max_window_size and assemble
     (at phase 7's 70-87 they merge and are skipped). The runner in this
     process with a plan sink (candidates, plans, windows assembled,
     reads whose alignment changed, seconds by stage with the
     realignment column), once more with the realigner off, then the
     stream with two workers on the card and phase 7's checks. Fails if
     no read was realigned or if the plans equal the realigner-off run's.
     The stream's CVOs go to a TFRecord and through the port's
     postprocess_variants CLI to a .vcf.gz and its .tbi.
  9. Long reads from files to a VCF: the long-read form of the seeded
     sample (single-end reads of a few kb with indel errors), the PACBIO
     preset with its defaults (direct read phasing on; the BAM's HP tags
     are not read) and output_phase_info, plans whose alt tensors come
     from reads realigned to each alt haplotype, and
     run_streaming_pipeline (the stream at 100x147x10 in diff mode, then
     stage 3 on the CVOs in memory) to a .vcf.gz, with phase 7's checks.
     Fails if no read got a phase, if the HP plane of the painted images
     is all zero, if no plan has alt_present set, or if no VCF record
     carries a phase set (PS). Prints the worker's "phase reads" seconds.
     Its CNN's het bias is raised by HET_BIAS: the seeded weights call
     het or hom-alt by a hair, and a phase set needs a het call.
     In phases 8 and 9 the VCF must equal, byte for byte, what
     postprocess_variants writes from the same CVOs in memory, hold one
     record per CVO group, and its .tbi must return the records of a
     region; each prints stage 3's seconds and records per second and
     the examples per second from the BAM to the VCF.
 10. The allele-frequency model from files to a VCF and a gVCF: the
     WGS preset with its defaults (realigner on) and the
     allele_frequency channel appended as --use_allele_frequency does
     (100x221x8, InceptionV3(8) with seeded weights, bfloat16, batch
     512), a population VCF and an exclude VCF written from the seeded
     sample's planted variants. The runner in this process with a plan
     sink and a gVCF TFRecord (make_gvcfs seconds per kb, candidates
     dropped by the exclude VCF), then run_streaming_pipeline with
     output_gvcf (the stream, then stage 3 merging the workers'
     reference blocks into the gVCF) with phase 7's checks, then the
     staged route on the same plans: PlanPredictor on the card, the CVOs
     to a TFRecord, the postprocess CLI with
     --nonvariant_site_tfrecord_path and --gvcf_outfile. Both VCFs and
     both gVCFs must be byte-identical. Then the runner with the
     vcf_candidate_importer and a proposed VCF, its plans through
     PlanPredictor on the card. Fails if the allele-frequency plane of
     the first painted batch is all zero, if an excluded site is among
     the candidates, if an importer candidate is not a proposed site,
     if the gVCF does not tile the contigs (every A, C, G or T base
     covered once by a reference block or a variant record, only
     variant records overlapping one another), if a VCF record is
     missing from the gVCF, or if the gVCF's .tbi does not answer a
     region query. Prints the gVCF records, make_gvcfs seconds per kb
     in one worker, the merge's seconds, the examples per second from
     the BAM to the gVCF, and the time of parsing a population VCF of
     COHORT_PARSE_RECORDS records whole, as every worker does.
 11. The one-step command, `scripts/run_deepvariant.py`, on a sample
     like phase 10's (WGS preset with its defaults, realigner on,
     100x221x7, a seeded checkpoint written to disk). First one shard in
     this process with an examples file: the host painter's ms per
     example, and beside each example the plan of the same candidate,
     which the CUDA plan form paints; every host-painted image must equal
     the card's bit for bit. Then (a) staged, 2 spawned make_examples
     shards, call_variants on the card, postprocess_variants with the
     gVCF: the shards' examples must equal the in-process shard's; (b)
     `--stream` with the device encoder; (c) `--stream` with a
     --channel_list the plan painter lacks (the WGS channels, gc_content
     and read_mapping_percent: 100x221x9), so the workers paint on the
     host. Every VCF must equal stage 3 on its CVOs and answer a .tbi
     query, every gVCF must tile the contigs; (a)'s and (b)'s VCFs may
     differ only at records where the CNN's bfloat16 moved a rounded
     probability (counted and printed). Prints each stage's seconds as
     run_deepvariant reports them, the examples per second from the BAM
     to the VCF of each route, stage 1's examples per second per shard,
     and the plan form's launches on (b).
 12. The read-side options of make_examples. Route A, the kernel's
     route: phase 11's sample with OQ tags and indels written
     right-shifted in homopolymers, the WGS defaults plus
     `--normalize_reads` and `--use_original_quality_scores`; one shard
     in this process (how many reads normalization rewrote and OQ
     replaced, normalization's seconds per kb; every host-painted image
     equal to the CUDA plan form's), then run_streaming_pipeline with the
     device encoder to a VCF (phase 7's checks, one launch of the plan
     form per batch), then the make_examples CLI with the same flags
     (its examples equal the in-process shard's), call_variants on the
     card and postprocess_variants; the two VCFs may differ only where
     bfloat16 moved a rounded probability. Route C: the make_examples
     CLI with the WGS channels and the three homopolymer-quality
     channels on the same reads' tp/t0 (realigner off: realigned reads
     drop their decoded tags, as in the JAX package), 100x221x10, and
     call_variants on the card. The candidate sweep: `--mode
     candidate_sweep` in 2 shards, the positions merged and partitioned.
     Route B: long reads with MM/ML tags (5mC at CpGs, haplotype-specific
     at a share of them, SNPs C>T at CpGs, some 6mA), the PACBIO channels
     plus base_methylation and base_6ma (100x147x12),
     `--enable_methylation_calling` and
     `--enable_methylation_aware_phasing`: one shard in this process
     (MM/ML parsing reads/s, methylation-aware phasing and MF/MD seconds
     per kb, reads assigned by methylation), run_deepvariant staged (2
     shards, the read-phase TSVs), merge_phased_reads and the postprocess
     CLI with the switches TSV, then `--stream` (the host encoder). Fails
     if no record carries MF, MD and MT or none MI, if the streamed VCF's
     methylation fields differ from the staged VCF's, or if the paint
     kernel was launched on this route (the methylation channels are the
     host painter's, as in the JAX package).
 13. CRAM input and training mode. Route A: phase 11's sample written as
     a CRAM (rANS order 1, the FASTA as reference, a .crai) by
     `testing/cram_writer.py`; one shard in this process from the CRAM
     (the CRAM decode's reads/s and share of the shard), whose plans and
     examples must equal phase 11's from the BAM bit for bit and whose
     host-painted images must equal the CUDA plan form's; then
     `run_deepvariant --reads x.cram` staged (2 shards) and `--stream`
     with the device encoder, each to a VCF and a gVCF with phase 11's
     checks; the staged VCF and gVCF may differ from phase 11's BAM
     route only where bfloat16 moved a rounded probability (counted and
     printed). Route B: a truth VCF and confident regions from the
     sample's planted variants (`synthetic.write_truth_inputs`); the
     make_examples CLI with `--mode training` and the default haplotype
     labeler on the CRAM and on the BAM: the examples and
     `.labeling_metrics.json` must be equal byte for byte; the runner in
     this process with a plan sink on the same options: its labeled
     plans, painted by the CUDA plan form, must equal the labeled
     examples image by image and label by label; labeled_examples_to_vcf
     turns the examples into a VCF. Prints TP/FP/FN sites, the labeler's
     seconds per kb and the launches of both routes.
 14. Training on the card. (a) Phase 13 route B's labeled examples (the
     CLI's TFRecords from the CRAM and the BAM, whose images phase 13
     held equal to the CUDA plan form's) as train and tune dataset
     configs: the train CLI (`scripts/train.py`, the `wgs_test` preset,
     InceptionV3(7) at full width, bfloat16, batch TRAIN_CLI_BATCH, two
     epochs) must write finite losses, the right step count, the epoch
     checkpoint, best.msgpack and example_info.json; the port's
     call_variants CLI from that best.msgpack over the same examples must
     give one CVO per example, within TRAIN_CALL_PROB_ATOL of the trained
     float32 model; train_resident on the same data must write its
     history, final.msgpack and best.msgpack. (b) One float32 step of
     InceptionV3(7) (dropout 0) at batch TRAIN_CHECK_BATCH from seeded
     weights, for sgd, adam and rmsprop, on the card and on the CPU,
     against the same step in float64 on the card: loss, the update of
     params and ema_params and of the optimizer's trees, batch_stats and
     counts, each within its stated limit; then the bfloat16 step's loss
     against the float32 step's. (c) TRAIN_EXAMPLES seeded examples
     resident on the card; ms per train step (forward, backward and
     update, back to back, CUDA events) at batch TRAIN_BATCH in bfloat16
     and float32 (TF32 off) with accumulation 1 and 4, each step's batch
     gathered on the card; examples/s, the peak of allocated memory and
     the share of the bf16 peak (989 TFLOP/s) at 3x the forward FLOPs
     counted from the conv shapes; once more in bfloat16 with cuDNN's
     autotuner on (the port leaves it off); then torch.profiler over
     three bfloat16 steps: the device's busy share and the ops that take
     its time. The paint kernel must not be launched in phase 14; the
     batch norm + ReLU kernels launch 4 times a layer in every timed
     step's micro-batches, 94 layers each (the count at batch TRAIN_BATCH
     x 4 goes on their entries of the kernels line).
 15. The small model, run_oracle_inference, the Keras import, export and
     stem rewrites, on phase 11's sample with phase 13's truth VCF and
     BED (rewritten from the same seed) and phase 14's checkpoint.
     (A) make_examples --mode training --write_small_model_examples
     (window 51) gives the training rows; the train_small_model CLI
     (`--config wgs`, 750x750, on the card) writes small_model.msgpack;
     the training loop (`small_model.train.fit`, 10 epochs on those
     rows from one init) in float32 on the card, held to float64 runs on
     the card and on the CPU: the float32 update within
     SMALL_MODEL_F64_RTOL of each (relative L2), the two float64 runs
     within SMALL_MODEL_F64_PAIR_RTOL, and a TF32 and a bfloat16 control
     on the card beyond SMALL_MODEL_F64_RTOL; then the wgs config's train
     step timed at its batch of 1024 on 8,192 seeded rows held on the
     card (CUDA events over back-to-back steps): ms/step, rows/s and the
     share of the float32 peak. (B) the
     gate on the main path, its GQ threshold the median phred of its
     calls on the rows: the runner in this process (its CVOs more than
     0 and fewer than phase 11's plans, and the plans left exactly phase
     11's minus the accepted alt sets), then run_deepvariant
     --call_small_model_examples staged and `--stream` (device encoder)
     to a VCF and a gVCF with phase 11's checks: the stream paints the
     runner's plans in ceil(plans / 512) launches, its small-model CVOs
     and the staged ones are the runner's, and the two VCFs differ only
     where bfloat16 moved a rounded probability; the plan form on these
     plans bit-exact against its plain version. (C) export_model from
     phase 14's best.msgpack, then call_variants --checkpoint <exported>
     on the card: the CVOs of best.msgpack with --use_ema, byte for byte;
     a seeded numpy stand-in of keras InceptionV3 layers through
     keras_import on the card equals, weights and probabilities, the
     model with the same weights placed by hand (keras's creation order
     onto the module's declared ConvBN order); InceptionV3(7) folded, padded to 8 channels and
     rewritten to the space-to-depth stem equals the plain graph in
     float32 within S2D_ATOL; the bfloat16 forward at batch 512 with and
     without the rewrites, timed. (D) run_oracle_inference (2 shards):
     every confident truth record at a biallelic oracle record is called
     with its truth genotype.
 16. Multi-sample make_examples and the one-step product scripts, on
     a seeded family, tumour/normal pair and read set with a 16-haplotype
     panel (`synthetic.synthetic_family`, `synthetic_tumor_normal`,
     `synthetic_pangenome`; 6 kb each, a variant every 400-500 bases, a
     seeded checkpoint written to disk): `run_deeptrio` (child and both
     parents, 40/60/40 rows: 140x221x7), `run_deepsomatic` on the pair
     with a panel of normals and on the tumour alone (200x221x7 and
     100x221x7) and `run_pangenome_aware_deepvariant` with the panel as
     a .gbz (200x221x7), each with `--device cuda`, printing its
     examples and stage seconds. Every trio example, painted on the
     host, must equal the CUDA plan form's planes of the same candidate
     (each sample's plan from its own ExamplesBuilder and support, one
     launch per sample per batch, stacked) bit for bit; every VCF must
     equal stage 3 on its CVOs in memory and answer a .tbi query; each
     script's examples go through call_variants once more in float32
     (TF32 off) on the card and on the CPU, whose CVOs may differ by at
     most F32_CARD_CPU_ATOL, and the VCF records that the card's
     bfloat16 moves against its float32 are counted. The
     multisample_make_examples CLI's trio (100/100/100 rows) gives
     300x221x7 examples; the bfloat16 InceptionV3(7) is timed at batch
     512 at 140, 200 and 300 rows, back to back and call by call, with
     the peak of allocated memory.
 17. Simulate, train, call, score: the port's read simulators fit their
     error models to seeded templates (a 30x short-read sample over 60
     kb, a long-read sample over 16 kb, written with the port's writers)
     and write five corpora with their truth VCFs and BEDs: a 9 kb
     training corpus, a 5 kb held-out corpus (another window and seed),
     and 10 kb each of long reads, a trio and a tumour/normal pair,
     printing variants, reads and seconds. (B) run_oracle_inference on the
     held-out corpus, scored by the port's vcf_eval against its truth
     inside its BED: F1 at least SIM_ORACLE_MIN_F1. (C) make_examples
     --mode training (WGS preset, SIM_SHARDS spawned shards) on the
     training corpus, tools/shuffle_tfrecords to 2 shards and a dataset
     config, the train CLI (wgs_test, full-width InceptionV3(7), batch
     SIM_TRAIN_BATCH, one epoch) on the card: ms per step. (D)
     run_deepvariant --stream (device encoder) with C's checkpoint on the
     held-out corpus: the plan form launched at least once; its CVOs
     through the postprocess CLI with --vcf_stats_report (the VCF equal
     to stage 3 in memory and to the stream's records, the stats counting
     them), scored by vcf_eval (no threshold: a few steps from random
     weights learn little); the plan form on the held-out corpus's own
     plans bit-exact against its plain version, timed. (E) the long-read
     corpus through run_deepvariant --model_type PACBIO --stream (the
     plan form launched at least once, bit-exact on its plans), the trio
     through run_deeptrio and the pair through run_deepsomatic (seeded
     checkpoints), each scored against its own truth (the child's, the
     somatic truth); the two drivers run one make_examples process with
     the realigner, so they call the first SIM_DRIVER_SPAN bases of
     their window and are scored there. Prints the F1s and the stages'
     seconds.
 18. torch.distributed on the one card. (A) NCCL at world size 1 from
     torchrun's variables (set in the phase): `initialize_multihost`,
     `all_gather_counts`, then MULTI_GPU_STEPS data-parallel train steps
     of InceptionV3(7) at full width (SGD with EMA, batch 64 in 2 micro
     batches, dropout 0, TF32 off) against the one-device step from the
     same state and batches, in float64 weights and in float32; ms per
     step (CUDA events) and the collectives' time. (B) two processes on
     the card that meet over gloo (a file store), the same steps on their
     rows of the same global batches: their states equal to each other
     bit for bit, and held to (A)'s one-device float64 step; ms per step
     and the seconds of the 87.1 MB gradient all-reduce and of the 376
     batch-norm collectives a step. The limits and why: MULTI_GPU_*.
     (C) `python -m deepvariant_tpu_torch.parallel.multihost` in two
     processes on the card against one process, over a seeded 12 kb
     sample in four regions: with the toy classifier the merged VCFs are
     equal byte for byte; with a seeded float32 checkpoint
     (`--use_model`) the CVOs have the same loci and probabilities within
     MULTI_GPU_PROB_ATOL and the VCFs the same records. (D) the prefetch
     iterator, `fused_encode_infer` and a Predictor with two replicas on
     the card (two streams) against the one-device Predictor, float32.
     The paint kernel must not be launched in (A)-(D) (the JAX
     multi-process path paints on the host): its entry on the kernels
     line says so (`expected_launches` 0). (E) a PlanPredictor with two
     replicas against one (a comparison, not counted). The machine has
     one card: no multi-card speed is measured.
 19. The nine accuracy drivers (scripts/accuracy_*.py and
     resume_somatic_eval), each through its `main(argv)` with `--device
     cuda`, on seeded stand-ins of the reference's data
     (testing/accuracy_inputs.py: templates, two short-read runs, a
     long-read run and a family simulated on one 32 kb reference, and
     windows of a few kb): accuracy_sim, accuracy_longread --family
     pacbio, accuracy_trio, accuracy_somatic and accuracy_hybrid stage by
     stage (gen, train, eval: simulate, label in ACC_WORKERS processes,
     one epoch of train_resident at batch ACC_BATCH, call on the card,
     stage 3, vcf_eval, the oracle and the fn audit), resume_somatic_eval
     on the somatic run (its JSON must equal the eval's), then
     accuracy_chr20 --cross_eval, accuracy_ont and accuracy_deeptrio
     with 2 folds (the streaming trainer). Prints each driver's stage
     seconds, labeled examples, model F1 and the oracle's F1 where the
     driver computes one; accuracy_sim's oracle must reach
     SIM_ORACLE_MIN_F1. The drivers paint on the host (0 launches,
     checked); the plan form then paints the plans of accuracy_sim's
     held-out calling examples (the runner in this process with the
     driver's options, whose examples equal the driver's byte for byte):
     every image equal to the driver's, bit for bit, and timed.
 20. One JSON line per the kernels, the card's name and power limit, and
     the result line.

The launch counts are set to 0 just before phases 3 and 4 (the WGS
paths) and read just after, again around phase 5 (the long-read path),
again around the stream of each of phases 7, 8, 9 and 10 (in phases 9
and 10 around run_streaming_pipeline: the stream, then stage 3, which
paints nothing), around each `--stream` run of phase 11 (the
host-encode one must launch none), around route A's stream in phase 12
and around the whole of route B (which must launch none), in phase 13
around route A's `--stream` run and around the painting of route B's
labeled plans, around the whole of phase 14 (training paints
nothing: it must count 0), in phase 15 around route B's `--stream`
run, and in phase 16 around the painting of the three DeepTrio targets'
planes (the multi-sample path paints on the host, as in the JAX
package: this is the smoke's check of the plan form on trio planes, not
a path of the package), and in phase 17 around the held-out and the
long-read `--stream` runs (their sum is the entry's launches),
in phase 18 around (A)-(D), which must count 0, and in phase 19 around
the nine drivers' runs (they paint on the host: they must count 0) and
then around the painting of accuracy_sim's held-out plans (the entry's
launches); the
comparisons of phase 2 and of the checks after the paths are not
counted. Any failed check raises, and the script exits non-zero; it also
exits non-zero, printing no result, when no CUDA card is available.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_CANDIDATES, ROWS, WIDTH, BAND = 512, 95, 221, 5
# The rows form's arguments among the plan's tensors, in
# `rows_form_args`' order.
ROWS_FORM_KEYS = ("bases", "quals", "mapq", "rev", "tlen", "support",
                  "row_valid", "ref_window")
LONGREAD_CHANNELS = (1, 2, 3, 4, 5, 6, 7, 26)   # the PACBIO preset's
ALL_DEVICE_CHANNELS = (1, 2, 3, 4, 5, 6, 7, 8, 19, 26)
# Non-default values of every color option and cap.
ODD_COLORS = dict(
    base_color_offset_a_and_g=33, base_color_offset_t_and_c=21,
    base_color_stride=55, allele_supporting_read_alpha=0.95,
    allele_unsupporting_read_alpha=0.45,
    other_allele_supporting_read_alpha=0.7,
    reference_matching_read_alpha=0.3,
    reference_mismatching_read_alpha=0.9, reference_base_quality=33,
    positive_strand_color=11, negative_strand_color=222,
    base_quality_cap=37, mapping_quality_cap=51,
    hp_tag_for_assembly_polishing=2)
# (name, N, PileupOptions fields) of the paint checks: the WGS path's
# shape, two whose tiles cut rows and candidates at odd offsets, the
# long-read path's shape, all twelve planes, and an odd shape with a
# shuffled channel order and ODD_COLORS.
PAINT_CASES = (
    ("wgs", N_CANDIDATES, dict()),
    ("wgs-band7", 3, dict(reference_band_height=7)),
    ("wgs-w100", 5, dict(width=100)),
    ("longread", N_CANDIDATES, dict(
        channels=LONGREAD_CHANNELS, alt_aligned_pileup="diff_channels",
        width=147)),
    ("12-planes", 16, dict(
        channels=ALL_DEVICE_CHANNELS, alt_aligned_pileup="diff_channels",
        width=147)),
    ("odd", 5, dict(
        channels=(26, 6, 19, 1, 8, 3, 7, 2, 5, 4, 1),
        alt_aligned_pileup="none", width=99, height=64,
        reference_band_height=3, **ODD_COLORS)),
    ("odd-diff", 7, dict(
        channels=(7, 5, 2, 26, 1), alt_aligned_pileup="diff_channels",
        width=53, height=41, reference_band_height=2, **ODD_COLORS)),
)
SHAPE = (100, 221, 7)
LONGREAD_SHAPE = (100, 147, 10)
AF_SHAPE = (100, 221, 8)       # WGS and the allele_frequency channel
N_EXAMPLES = 512
STAGED_REPEATS = 8  # the example file is read this many times when timed
N_PLANS = 1024
BATCH = 512
SEED = 20261016
# Phase 7's sample: two contigs, 30x of paired 150-base reads, a variant
# planted every 70-87 bases: about 5,000 examples, ten batches.
STREAM_CONTIGS = (("chr1", 250_000), ("chr2", 110_000))
STREAM_WORKERS = 2
# Phase 8's sample: the same kind of reads, a variant every 400-500
# bases. The port's realigner is Python and numpy and takes a few tenths
# of a second per kb, which sizes this.
REALIGN_CONTIGS = (("chr1", 26_000), ("chr2", 14_000))
REALIGN_VARIANT_SPACING = 400
# Phase 9's sample: 20x of single-end reads of about 3 kb.
LONGREAD_CONTIGS = (("chr1", 50_000), ("chr2", 25_000))
# Added to phase 9's het logit (see phase_longread_stream).
HET_BIAS = 0.5
# Phase 10's sample: phase 8's kind of reads and variant spacing, 20 kb;
# the realigner's 0.33-0.49 s per kb in one worker sizes it.
AF_CONTIGS = (("chr1", 12_000), ("chr2", 8_000))
CH_ALLELE_FREQUENCY = 8        # the channel --use_allele_frequency appends
# Records of the population VCF whose whole-file parse phase 10 times.
COHORT_PARSE_RECORDS = 50_000
# Phase 11: run_deepvariant on a sample like phase 10's (WGS defaults),
# and the host-encode stream's channel list: the WGS channels and two
# that the plan painter lacks (100x221x9).
RUN_DV_CONTIGS = (("chr1", 12_000), ("chr2", 8_000))
RUN_DV_HOST_CHANNELS = ("BASE_CHANNELS,insert_size,gc_content,"
                        "read_mapping_percent")
RUN_DV_HOST_SHAPE = (100, 221, 9)
# Phase 12. Route A: phase 11's sample with OQ tags and indels written
# right-shifted in homopolymers; route C: the WGS channels and the three
# homopolymer-quality channels on its reads' tp/t0; route B: long reads
# with 5mC at CpGs (haplotype-specific at a share of them) and 6mA, the
# PACBIO channels and the two methylation channels.
READ_OPTIONS_SHIFTED_INDELS = 60
ULTIMA_CHANNEL_LIST = ("BASE_CHANNELS,insert_size,"
                       "homopolymer_insertion_quality,"
                       "homopolymer_deletion_quality,"
                       "inter_homopolymer_insertion_quality")
ULTIMA_SHAPE = (100, 221, 10)
SWEEP_PARTITION_CANDIDATES = 8
METH_CONTIGS = (("chr1", 24_000), ("chr2", 12_000))
METH_DEPTH = 15
METH_READ_LENGTH = 2000
METH_SPACING = 600
METH_CHANNEL_LIST = ("BASE_CHANNELS,haplotype,supplementary_alignment,"
                     "base_methylation,base_6ma")
METH_SHAPE = (100, 147, 12)

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
# The batch norm + ReLU kernels against the plain version at batch 2,048
# in bfloat16, relative L2 distance (the order is that of the outputs
# compared). At the largest layer of each preset the card read at most
# y 9.2e-5, dx 8.1e-5, dbias 1.8e-7, the running statistics 1.3e-7.
BN_LIMITS = {"y": 4e-3, "dx": 8e-3, "dbias": 1e-4, "running_mean": 1e-6,
             "running_var": 1e-6}
# Where the two versions' ReLU gates differ: at most this share of the
# elements, each with its float64 pre-activation within BN_GATE_MARGIN of
# 0 (as tests/test_torch_batch_norm_relu.py holds bfloat16).
BN_GATE_SHARE = 1e-3
BN_GATE_MARGIN = 1e-4
H100_FP32_FLOPS = 67e12          # float32 outside the tensor cores
# Phase 14: training on the card.
TRAIN_CLI_BATCH = 8            # the CLI and train_resident on phase 13's
TRAIN_CALL_PROB_ATOL = 0.05    # bfloat16 CVOs vs the float32 model
TRAIN_CHECK_BATCH = 8          # the card-vs-CPU step
# Optimizer trees compared in the card-vs-CPU step, besides params and
# ema_params.
TRAIN_CHECK_GROUPS = {
    "sgd": [("params",), ("ema_params",), ("opt_state", "0", "trace")],
    "adam": [("params",), ("ema_params",), ("opt_state", "0", "mu"),
             ("opt_state", "0", "nu")],
    "rmsprop": [("params",), ("ema_params",), ("opt_state", "0", "nu"),
                ("opt_state", "2", "trace")],
}
# Relative L2 distance of a float32 step's update from the float64
# step's, and of the card's from the CPU's. Measured on the CPU at batch
# 8 (float32 against float64): sgd 0.026, adam 0.129 (its first step
# moves every weight by about +-lr, and gradients near 0 flip sign),
# rmsprop 0.072; the limits are 3-4 times those.
TRAIN_CHECK_RTOL = {"sgd": 0.1, "adam": 0.4, "rmsprop": 0.25}
TRAIN_LOSS_RTOL = 1e-4
TRAIN_STATS_RTOL = 1e-4
# The bfloat16 step's loss against the float32 step's, measured on the
# CPU: 8.5e-4 at batch 8, 3.2e-2 at batch 2.
TRAIN_BF16_LOSS_RTOL = 5e-2
TRAIN_EXAMPLES = 4096          # 634 MB of 100x221x7 resident
TRAIN_BATCH = 512
# (dtype, accumulation, timed steps, warm-up steps)
TRAIN_TIMINGS = (("bfloat16", 1, 10, 3), ("bfloat16", 4, 4, 1),
                 ("float32", 1, 4, 1), ("float32", 4, 2, 1))
BF16_PEAK_FLOPS = 989e12       # H100 SXM dense bf16 (NVIDIA's data sheet)
# Phase 15: the small model, run_oracle_inference, the Keras import, export
# and stem rewrites.
SMALL_MODEL_WINDOW = 51        # the make_examples CLI's context window
# The loop's float32 params against float64's (relative L2 of the update,
# 10 epochs on phase 15's 50 rows), measured on the CPU: float32 1.03e-5,
# float64 across thread counts 5.7e-15, bfloat16 0.708; on the card (the
# float32 bundle against the float64 one) 5.88e-6. The limits are about
# 5 times the float32 reading and far above float64's.
SMALL_MODEL_F64_RTOL = 5e-5
SMALL_MODEL_F64_PAIR_RTOL = 1e-10
SMALL_MODEL_TIMING_ROWS = 8192
SMALL_MODEL_TIMING_STEPS = (20, 3)   # timed steps, warm-up steps
FP32_PEAK_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
S2D_ATOL = 1e-4                # folded + padded + s2d vs plain, float32
PAINT_OPS_PER_PIXEL = 10         # min, mul, div (quality) + 7 mask muls

# Phase 16: the seeded family, tumour/normal pair and pangenome panel,
# 6 kb each with a variant every 400-500 bases (the one-step scripts run
# the realigner, whose windows then assemble), and the WGS channels they
# set.
MULTISAMPLE_CONTIGS = (("chr1", 6_000),)
MULTISAMPLE_SPACING = 400
MULTISAMPLE_CHANNELS = 7
F32_CARD_CPU_ATOL = 1e-4       # float32 CVOs, the card (TF32 off) vs the CPU

# Phase 17: the templates the simulators fit their error models to (a
# 30x short-read sample and a long-read sample, seeded), and the corpora
# simulated from them: name -> (simulator, config fields).
SIM_CONTIG = "chr20"
SIM_TEMPLATE_LENGTH = 60_000
SIM_LONG_TEMPLATE_LENGTH = 16_000
SIM_CORPORA = {
    "train": ("short", dict(seed=1, windows=[(5_000, 14_000)])),
    "heldout": ("short", dict(seed=2, windows=[(35_000, 40_000)])),
    "long": ("long", dict(seed=3, windows=[(2_000, 12_000)])),
    # De novo and somatic rates raised so that 10 kb hold a few of each;
    # depths lowered for the drivers' host time (below).
    "trio": ("trio", dict(seed=4, windows=[(5_000, 15_000)],
                          de_novo_snv_rate=1 / 2000, coverage_child=20.0,
                          coverage_parent=20.0)),
    "pair": ("somatic", dict(seed=5, windows=[(45_000, 55_000)],
                             somatic_snv_rate=1 / 1000,
                             somatic_indel_rate=1 / 5000,
                             coverage_tumor=40.0, coverage_normal=20.0)),
}
# The trio and pair drivers run one make_examples process each, with the
# realigner (no flag turns it off), whose host time grows with the
# simulated error process: they call, and are scored over, the first
# SIM_DRIVER_SPAN bases of their corpus's window.
SIM_DRIVER_SPAN = {"trio": 2_500, "pair": 1_500}
SIM_ORACLE_MIN_F1 = 0.9        # the oracle's F1 on the held-out corpus
SIM_SHARDS = 4                 # make_examples shards (processes) per run
SIM_PLAN_SPAN = 1_500          # the held-out plans held against the plain
SIM_TRAIN_BATCH = 32
# Phase 18, multi-GPU. The data-parallel steps: InceptionV3(7) at full
# width, SGD with EMA, a global batch of 64 in 2 micro batches, 3 steps.
MULTI_GPU_BATCH = 64
MULTI_GPU_ACCUM = 2
MULTI_GPU_STEPS = 3
MULTI_GPU_SHAPE = SHAPE
# A train step of this network is ill-conditioned: a relative 1e-7
# change of batch norm's sums moves the float32 update by 2.8-3.6%
# (measured on the CPU), and over steps the runs drift apart: a float32
# run is 2.4% from the float64 one after one step and 78% after three
# (on the card at full width). So each run is held after its first
# step, and the distances after the last are printed. The data-parallel
# runs are held to the one-device step in float64 weights: the relative
# L2 distance of the updates (params, ema_params, the momentum trace)
# within 1e-4, the batch-norm statistics within 1e-5 of each leaf's
# largest value, the loss within 1e-5. The head stays float32 in any
# weight dtype (as the JAX model's), and its rounding, amplified by the
# float64 backward, sets that floor where the ranks' sums split the
# batch: updates 0.5-1.5e-5 apart and statistics 1.6e-6 on the CPU at
# 75x75, batch 8. The float32 runs are held to the one-device float64
# run as phase 14 holds its float32 step: update distance within 0.15
# and the loss within 1e-4.
MULTI_GPU_F64_DISTANCE = 1e-4
MULTI_GPU_F64_STATS_RTOL = 1e-5
MULTI_GPU_F64_LOSS_RTOL = 1e-5
MULTI_GPU_F32_DISTANCE = 0.15
MULTI_GPU_LOSS_RTOL = 1e-4
MULTI_GPU_CONTIGS = (("chr1", 8_000), ("chr2", 4_000))
MULTI_GPU_REGIONS = ("chr1:1-4000", "chr1:4001-8000", "chr2:1-2000",
                     "chr2:2001-4000")
MULTI_GPU_PROB_ATOL = 1e-5     # float32 probabilities, parts against whole
MULTI_GPU_EXAMPLES = 1100      # (D): three batches of 512, the last padded
MULTI_GPU_RANK_TIMEOUT_S = 600
# Phase 19: the nine accuracy drivers on the seeded stand-ins of
# testing/accuracy_inputs.py (windows of a few kb), through their
# main(argv) on the card: one epoch at batch ACC_BATCH (a few steps of
# the full-width InceptionV3), ACC_WORKERS make_examples processes, and
# accuracy_sim's eval over 3 kb of the stand-in runs' 4 kb window.
ACC_BATCH = 4
ACC_WORKERS = 4
ACC_EVAL_SPAN = (6_000, 9_000)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of `reps` single-call times on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 50, repeats: int = 3) -> float:
    """Device time per call of `fn` (CUDA events), the median of
    `repeats` runs of `reps` calls queued behind a spin kernel, so that
    the card runs them back to back whatever the host's launch cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    start_s = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - start_s
    times = []
    for _ in range(repeats):
        # Long enough for the host to queue all `reps` calls (2 GHz bound
        # on the SM clock), at most a second.
        torch.cuda._sleep(int(min(2 * reps * host_s, 1.0) * 2e9))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def random_plans(n: int, seed: int, rows: int = ROWS, width: int = WIDTH,
                 alt: bool = False):
    """n plan dicts with invalid rows, N and '*' bases, q up to 255, mapq
    above the cap, support codes and hp in and outside 0..2, and tlen
    negative and huge, -2**31 included. With `alt` they carry the alt
    tensors of diff mode, with alt_present in all four combinations."""
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(b"ACGTN*", np.uint8)

    def random_bases(*shape):
        bases = alphabet[rng.randint(0, 6, shape)]
        bases[rng.rand(*shape) < 0.3] = 0
        return bases

    tlen = rng.randint(-5000, 5000, (n, rows)).astype(np.int32)
    tlen[:, :3] = [-2**31, -2**31 + 1, 2**31 - 1]
    support = rng.randint(0, 3, (n, rows)).astype(np.int8)
    support[:, 3:9] = [-1, -2, -3, -128, 3, 127]
    hp = rng.randint(0, 3, (n, rows)).astype(np.int8)
    hp[:, 9:13] = [-128, -1, 3, 127]
    stacked = {
        "bases": random_bases(n, rows, width),
        "quals": rng.randint(0, 256, (n, rows, width)).astype(np.uint8),
        "mapq": rng.randint(0, 256, (n, rows)).astype(np.uint8),
        "rev": rng.rand(n, rows) < 0.5,
        "hp": hp,
        "tlen": tlen,
        "supp": rng.rand(n, rows) < 0.1,
        "support": support,
        "af": rng.randint(0, 256, (n, rows)).astype(np.uint8),
        "row_valid": rng.rand(n, rows) < 0.85,
        "ref_window": alphabet[rng.randint(0, 5, (n, width))],
    }
    if alt:
        present = np.array([[1, 1], [0, 1], [1, 0], [0, 0]], bool)
        stacked.update({
            "alt_bases": random_bases(n, 2, rows, width),
            "alt_row_valid": rng.rand(n, 2, rows) < 0.85,
            "alt_ref": alphabet[rng.randint(0, 5, (n, 2, width))],
            "alt_present": present[rng.randint(0, 4, n)],
        })
        stacked["alt_present"][:4] = present[:n]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def phase_build() -> float:
    from deepvariant_tpu_torch.ops import _build

    start = time.time()
    messages = _build.build()
    seconds = time.time() - start
    for name, text in messages.items():
        print(f"[build] {name}.cu:\n{text.strip()}")
    print(f"[build] {len(_build.source_names())} kernel source(s) ready in "
          f"{seconds:.2f} s")
    return seconds


def n_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(tensors, out) -> tuple:
    """(bound ms, bound_by): each input read once and the output written
    once at the card's memory rate, against the paint's float32
    operations at its peak."""
    bytes_ms = (n_bytes(tensors) + n_bytes([out])) / H100_BYTES_PER_S * 1e3
    pixels = out.numel() // out.shape[-1]
    ops_ms = pixels * PAINT_OPS_PER_PIXEL / H100_FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def kernels_launched(fn, tries: int = 3) -> list:
    """Names of the device activities (kernels, copies, fills) of one
    call of `fn`, traced by torch.profiler. The device tracer does not
    deliver its records in every session (a second session of one
    process can come back empty), so an empty trace is taken again, and
    the list is empty only if every one of `tries` sessions was."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            return names
    return []


def one_launch_one_tensor(fn) -> tuple:
    """(kernel launches counted by the paint wrapper, device tensors
    allocated) in one call of `fn`, read from the wrapper's count and
    the caching allocator's: a painter that is one kernel launches once
    and allocates its output and no temporary."""
    import torch

    from deepvariant_tpu_torch.ops import pileup_paint as pp

    fn()
    torch.cuda.synchronize()
    launches = pp.paint_pileup.launches
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    torch.cuda.synchronize()
    return (pp.paint_pileup.launches - launches,
            torch.cuda.memory_stats()["allocation.all.allocated"] - allocated)


def stack_plans(plans, keys, device):
    import torch

    return [torch.from_numpy(np.stack([p[k] for p in plans])).to(device)
            for k in keys]


def phase_paint_kernel(device) -> list:
    """Both forms of the paint kernel against their plain versions at
    PAINT_CASES, their timings at the WGS and long-read shapes, and the
    painter's one launch. Returns the three entries of the kernels line
    (the WGS paths, the long-read path, the from-files stream path)."""
    import torch

    from deepvariant_tpu_torch.make_examples.pileup import (
        WGS_CHANNELS,
        PileupOptions,
    )
    from deepvariant_tpu_torch.make_examples.pileup_device import (
        ALT_KEYS,
        PLAN_KEYS,
        make_longread_encode_fn,
    )
    from deepvariant_tpu_torch.ops import pileup_paint as pp

    max_err, cases = 0, {}
    for k, (name, n, fields) in enumerate(PAINT_CASES):
        options = PileupOptions(**fields)
        painter = make_longread_encode_fn(options)
        rows, width = options.max_reads, options.width
        plans = random_plans(n, SEED + k, rows, width, alt=True)
        args = stack_plans(plans, PLAN_KEYS + ALT_KEYS, device)
        checks = {"plan": (
            pp.paint_pileup_plan(*args, painter.colors),
            pp.paint_pileup_plan_reference(*args, painter.colors))}
        rows_args = None
        if tuple(options.channels) == tuple(WGS_CHANNELS):
            rows_args = pp.rows_form_args(
                *stack_plans(plans, ROWS_FORM_KEYS, device), painter.colors)
            checks["rows"] = (pp.paint_pileup(*rows_args),
                              pp.paint_pileup_reference(*rows_args))
        torch.cuda.synchronize()
        for form, (out, plain) in checks.items():
            shape = (n, rows + (options.reference_band_height
                                if form == "plan" else 0), width,
                     painter.colors.planes)
            if tuple(out.shape) != shape or out.shape != plain.shape:
                raise AssertionError(
                    f"paint kernel, {form} form, case {name}: shape "
                    f"{tuple(out.shape)}, plain {tuple(plain.shape)}, "
                    f"expected {shape}")
            err = int((out.int() - plain.int()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(out, plain):
                raise AssertionError(
                    f"paint kernel, {form} form, differs from its plain "
                    f"version in case {name} (max abs err {err})")
        print(f"[paint] {' and '.join(sorted(checks))} == plain in case "
              f"{name}: N={n} R={rows} band={options.reference_band_height} "
              f"W={width} planes={painter.colors.planes}")
        cases[name] = (painter, args, rows_args)

    timed = {}
    for name in ("wgs", "longread"):
        painter, args, rows_args = cases[name]
        counted = one_launch_one_tensor(lambda: painter(*args))
        launched = kernels_launched(lambda: painter(*args))
        print(f"[paint] one {name} painter call on the card: {counted[0]} "
              f"launch, {counted[1]} tensor allocated, traced "
              f"{launched if launched else 'nothing (the profiler gave no device records)'}")
        if counted != (1, 1):
            raise AssertionError(
                f"the {name} painter made {counted[0]} kernel launches and "
                f"{counted[1]} device allocations, not one of each")
        if launched and (len(launched) != 1
                         or "paint_kernel" not in launched[0]):
            raise AssertionError(
                f"the {name} painter launched {len(launched)} device "
                f"activities, not one paint kernel: {launched}")
        forms = [("plan", lambda *a: pp.paint_pileup_plan(*a, painter.colors),
                  lambda *a: pp.paint_pileup_plan_reference(
                      *a, painter.colors),
                  args, args if painter.colors.diff else args[:len(PLAN_KEYS)])]
        if rows_args is not None:
            forms.append(("rows", pp.paint_pileup, pp.paint_pileup_reference,
                          rows_args, rows_args))
        for form, kernel, plain, call_args, read_args in forms:
            out = kernel(*call_args)
            bound_ms, bound_by = bound(read_args, out)
            kernel_ms = device_ms(lambda: kernel(*call_args))
            plain_ms = device_ms(lambda: plain(*call_args), reps=10)
            timed[name, form] = (kernel_ms, plain_ms, bound_ms, bound_by)
            print(f"[paint] {name}, {form} form at {tuple(out.shape)}: "
                  f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}, "
                  f"{n_bytes(read_args) + n_bytes([out])} bytes): "
                  f"{bound_ms / kernel_ms:.1%} of the bound")
        # A yardstick, not the same function: PyTorch's fill of a tensor
        # the size of the plan form's output, the write traffic alone.
        image = torch.empty_like(painter(*args))
        timed[name, "fill"] = device_ms(lambda: image.fill_(7))
        print(f"[paint] fill_ of the {n_bytes([image])}-byte {name} image: "
              f"{timed[name, 'fill']:.4f} ms")

    def entry(name, key, **more):
        return kernel_entry(name, *timed[key], max_err, **more)

    plan_ms, plan_plain_ms, plan_bound_ms, plan_bound_by = timed["wgs", "plan"]
    return [
        # The rows form (the TPU kernel's counterpart) and the plan form
        # at the WGS paths' shape, 512x95x221, 7 planes.
        entry("pileup_paint", ("wgs", "rows"), plan_ms=plan_ms,
              plan_plain_ms=plan_plain_ms, plan_bound_ms=plan_bound_ms,
              plan_bound_by=plan_bound_by,
              image_fill_ms=timed["wgs", "fill"]),
        # The plan form at the long-read path's shape, 512x95x147, 8
        # channels and the two diff planes.
        entry("pileup_paint_longread", ("longread", "plan"),
              image_fill_ms=timed["longread", "fill"]),
        # The plan form on the from-files stream path: the WGS shape
        # again, 512x(5+95)x221, 7 planes, once per batch of 512.
        entry("pileup_paint_plan_from_files", ("wgs", "plan"),
              image_fill_ms=timed["wgs", "fill"]),
    ]


def network_layers(shape) -> list:
    """[(C, H, W, count)] of the outputs of InceptionV3's 94 ConvBNs at
    an (H, W, C) pileup, largest first (a forward on the CPU)."""
    import torch

    from deepvariant_tpu_torch.models.inception_v3 import ConvBN, InceptionV3

    model = InceptionV3(shape[2]).eval()
    seen = []
    for m in model.modules():
        if isinstance(m, ConvBN):
            m.register_forward_hook(
                lambda mod, inp, out: seen.append(tuple(out.shape[1:])))
    with torch.no_grad():
        model(torch.zeros((1,) + tuple(shape)))
    counts = {s: seen.count(s) for s in seen}
    return sorted(((c, h, w, k) for (c, h, w), k in counts.items()),
                  key=lambda t: -t[0] * t[1] * t[2])


def phase_batch_norm_relu(device, card: str) -> list:
    """The training batch norm + ReLU kernels at the main path's shapes:
    held to the plain version and timed at every distinct layer shape at
    batch 2,048. Their launches on the train step are counted in phase
    14 (`time_train_steps`)."""
    import torch
    import torch.nn.functional as F

    from deepvariant_tpu_torch.models.inception_v3 import BN_EPSILON
    from deepvariant_tpu_torch.ops import batch_norm_relu as bnr

    batch, momentum, dtype = 2048, 0.9997, torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED + 20)

    def layer(c, h, w):
        x = (torch.randn((batch, h, w, c), device=device, generator=gen)
             * 1.7 + 0.4).to(dtype).permute(0, 3, 1, 2)
        dy = torch.randn((batch, h, w, c), device=device, generator=gen
                         ).to(dtype).permute(0, 3, 1, 2)
        bias = torch.randn(c, device=device, generator=gen) * 0.5
        return x, dy, bias, torch.zeros(c, device=device), \
            torch.ones(c, device=device)

    def fused(x, dy, bias, rm, rv):
        y, mean, rstd = bnr.forward_kernel(x, bias, rm, rv, momentum,
                                           BN_EPSILON)
        return (y,) + bnr.backward_kernel(dy, x, bias, mean, rstd)

    def plain(x, dy, bias, rm, rv):
        x = x.detach().requires_grad_(True)
        b = bias.detach().requires_grad_(True)
        y = bnr.batch_norm_relu_reference(x, b, rm, rv, momentum,
                                          BN_EPSILON)
        return (y,) + torch.autograd.grad(y, (x, b), dy)

    def library(x, dy, bias, rm, rv):
        x = x.detach().requires_grad_(True)
        b = bias.detach().requires_grad_(True)
        y = F.relu(F.batch_norm(x, rm, rv, torch.ones_like(b), b, True,
                                1 - momentum, BN_EPSILON))
        return (y,) + torch.autograd.grad(y, (x, b), dy)

    def compare(x, dy, bias, rm, rv):
        """Relative L2 distances of the kernels' outputs, gradients and
        running statistics from the plain version's, one step from the
        same running statistics. A pre-activation within rounding of 0
        may fall on either side of the ReLU's gate in the two (their
        statistics differ in the last place, and every element of a
        channel that holds the same bfloat16 value falls the same way),
        so the plain version's backward takes the kernels' gate (their
        y > 0). Also the share of elements whose gates differ and the
        largest float64 pre-activation among them."""
        rm_k, rv_k, rm_p, rv_p = (t.clone() for t in (rm, rv, rm, rv))
        y, dx, dbias = fused(x, dy, bias, rm_k, rv_k)
        xp = x.detach().requires_grad_(True)
        bp = bias.detach().requires_grad_(True)
        z = bnr.batch_norm_train_reference(xp, bp, rm_p, rv_p, momentum,
                                           BN_EPSILON)
        gate = y > 0
        dxp, dbp = torch.autograd.grad(z, (xp, bp), dy * gate)
        z = z.detach()
        rel = {k: float((a.double() - b.double()).norm()
                        / b.double().norm())
               for k, a, b in zip(BN_LIMITS, (y, dx, dbias, rm_k, rv_k),
                                  (F.relu(z), dxp, dbp, rm_p, rv_p))}
        differ = gate != (z > 0)
        rel["gate_share"] = float(differ.double().mean())
        rel["gate_margin"] = 0.0
        if rel["gate_share"] > 0:
            c = x.shape[1]
            x64 = x.double()
            mean = x64.mean(dim=(0, 2, 3)).view(1, c, 1, 1)
            rstd = torch.rsqrt(x64.var(dim=(0, 2, 3), unbiased=False)
                               + BN_EPSILON).view(1, c, 1, 1)
            pre = (x64 - mean) * rstd + bias.double().view(1, c, 1, 1)
            rel["gate_margin"] = float(pre[differ].abs().max())
            del x64, pre
        return rel

    entries = []
    for preset, shape in (("wgs", SHAPE), ("pacbio", LONGREAD_SHAPE)):
        layers = network_layers(shape)
        totals = {"kernel": 0.0, "plain": 0.0, "library": 0.0,
                  "forward": 0.0, "backward": 0.0, "bound": 0.0}
        worst = {}
        for rank, (c, h, w, count) in enumerate(layers):
            x, dy, bias, rm, rv = layer(c, h, w)
            rel = compare(x, dy, bias, rm, rv)
            print(f"[bn] {preset} {batch}x{c}x{h}x{w} bf16 against the "
                  "plain version (relative L2): " + ", ".join(
                      f"{k} {v:.2e}" for k, v in rel.items()) + f"; {card}")
            if any(rel[k] > limit for k, limit in BN_LIMITS.items()) or \
                    rel["gate_share"] > BN_GATE_SHARE or \
                    rel["gate_margin"] > BN_GATE_MARGIN:
                raise AssertionError(f"batch norm kernels at {preset} "
                                     f"{batch}x{c}x{h}x{w}: {rel}")
            worst = {k: max(worst.get(k, 0.0), v) for k, v in rel.items()}
            reps = 20 if rank < 3 else 10
            y, mean, rstd = bnr.forward_kernel(x, bias, rm, rv, momentum,
                                               BN_EPSILON)
            ms = {
                "kernel": device_ms(lambda: fused(x, dy, bias, rm, rv),
                                    reps),
                "forward": device_ms(lambda: bnr.forward_kernel(
                    x, bias, rm, rv, momentum, BN_EPSILON), reps),
                "backward": device_ms(lambda: bnr.backward_kernel(
                    dy, x, bias, mean, rstd), reps),
                "plain": device_ms(lambda: plain(x, dy, bias, rm, rv),
                                   reps),
                "library": device_ms(lambda: library(x, dy, bias, rm, rv),
                                     reps),
                "bound": 16 * x.numel() / H100_BYTES_PER_S * 1e3,
            }
            for k in totals:
                totals[k] += count * ms[k]
            if rank < 3:
                entries.append(bn_entry(
                    f"batch_norm_relu_{preset}_{batch}x{c}x{h}x{w}", ms,
                    count, rel))
                print(f"[bn] {preset} {batch}x{c}x{h}x{w} (x{count}): "
                      f"kernel {ms['kernel']:.4f} ms (forward "
                      f"{ms['forward']:.4f}, backward {ms['backward']:.4f}),"
                      f" bound {ms['bound']:.4f} "
                      f"({100 * ms['bound'] / ms['kernel']:.1f}%), plain "
                      f"{ms['plain']:.4f}, library {ms['library']:.4f}; "
                      f"{card}")
            del x, dy, y, mean, rstd
        entries.append(bn_entry(f"batch_norm_relu_{preset}_{batch}_all94",
                                totals, 94, worst))
        print(f"[bn] {preset} all 94 layers at {batch}: kernel "
              f"{totals['kernel']:.3f} ms a step (forward "
              f"{totals['forward']:.3f}, backward {totals['backward']:.3f}),"
              f" bound {totals['bound']:.3f} "
              f"({100 * totals['bound'] / totals['kernel']:.1f}%), plain "
              f"{totals['plain']:.3f}, library {totals['library']:.3f}; "
              f"{card}")
    torch.cuda.empty_cache()
    return entries


def bn_entry(name, ms, layers, errors) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": "deepvariant_tpu_torch/csrc/batch_norm_relu.cu",
        "replaces": None,
        "tpu_kernel": None,
        "launches": None,   # phase 14's train steps
        "layers": layers,
        "max_rel_err": errors,
        "ms": ms["kernel"],
        "kernel_ms": ms["kernel"],
        "forward_ms": ms["forward"],
        "backward_ms": ms["backward"],
        "plain_ms": ms["plain"],
        "bound_ms": ms["bound"],
        "bound_by": "bytes",
        "library_ms": ms["library"],
    }


def network_pools(shape) -> list:
    """[(kind, C, H, W, count)] of the inputs of InceptionV3's 13 pools
    ('box' for the 3x3 box filter, 'max' for the 3x3 stride-2 max pool)
    at an (H, W, C) pileup, in the order a forward first runs them (a
    forward on the CPU)."""
    import torch

    from deepvariant_tpu_torch.models.inception_v3 import InceptionV3
    from deepvariant_tpu_torch.ops import pool

    seen = []
    real = {"box": pool.box3x3, "max": pool.max3x3s2}

    def spy(kind):
        def watched(x):
            seen.append((kind,) + tuple(x.shape[1:]))
            return real[kind](x)
        return watched

    try:
        pool.box3x3, pool.max3x3s2 = spy("box"), spy("max")
        with torch.no_grad():
            InceptionV3(shape[2]).eval()(torch.zeros((1,) + tuple(shape)))
    finally:
        pool.box3x3, pool.max3x3s2 = real["box"], real["max"]
    order = list(dict.fromkeys(seen))
    return [k + (seen.count(k),) for k in order]


def phase_pool(device, card: str) -> list:
    """The pool kernels at the main path's shapes: every distinct pool
    shape of both presets at batch 2,048, held bit for bit to torch's own
    CUDA pools (the plain version: the code before the kernels) in
    bfloat16 and float32, run twice (bit-equal), and timed forward and
    backward in bfloat16 beside the byte floor (each pool's input and
    output once each way), the plain version and torch's library call.
    Their launches on the train step are counted in phase 14
    (`time_train_steps`)."""
    import torch
    import torch.nn.functional as F

    from deepvariant_tpu_torch.ops import pool

    batch = 2048
    gen = torch.Generator(device=device).manual_seed(SEED + 21)

    def tensor(shape, dtype):
        n, c, h, w = shape
        return torch.randn((n, h, w, c), device=device, generator=gen
                           ).to(dtype).permute(0, 3, 1, 2)

    def kernels(kind, x, dy):
        if kind == "box":
            return pool.box3x3_kernel(x), pool.box3x3_kernel(dy)
        return (pool.max3x3s2_forward_kernel(x),
                pool.max3x3s2_backward_kernel(dy, x))

    def plain(kind, x, dy):
        """The code before the kernels: the box filter's forward and its
        backward (the pool of dy) through F.avg_pool2d; F.max_pool2d and
        its autograd backward."""
        if kind == "box":
            return (F.avg_pool2d(x, 3, 1, 1, count_include_pad=True),
                    F.avg_pool2d(dy, 3, 1, 1, count_include_pad=True))
        xr = x.detach().requires_grad_(True)
        y = F.max_pool2d(xr, 3, stride=2)
        return (y.detach(),) + torch.autograd.grad(y, xr, dy)

    def library(kind, x, dy):
        """torch's own pool with its own backward (for the box filter,
        avg_pool2d's backward, wrong for channels_last input: timed
        only)."""
        xr = x.detach().requires_grad_(True)
        y = F.avg_pool2d(xr, 3, 1, 1, count_include_pad=True) \
            if kind == "box" else F.max_pool2d(xr, 3, stride=2)
        return (y.detach(),) + torch.autograd.grad(y, xr, dy)

    def same_bits(a, b):
        ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.contiguous().view(ints[a.dtype]),
            b.contiguous().view(ints[b.dtype]))

    entries = []
    for preset, shape in (("wgs", SHAPE), ("pacbio", LONGREAD_SHAPE)):
        totals = {"kernel": 0.0, "forward": 0.0, "backward": 0.0,
                  "plain": 0.0, "library": 0.0, "bound": 0.0}
        calls = 0
        for kind, c, h, w, count in network_pools(shape):
            calls += count
            ho, wo = (h, w) if kind == "box" else \
                ((h - 3) // 2 + 1, (w - 3) // 2 + 1)
            for dtype in (torch.bfloat16, torch.float32):
                x = tensor((batch, c, h, w), dtype)
                dy = tensor((batch, c, ho, wo), dtype)
                got = kernels(kind, x, dy)
                again = kernels(kind, x, dy)
                want = plain(kind, x, dy)
                for what, a, b, r in zip(("forward", "backward"), got, want,
                                         again):
                    if not same_bits(a, b):
                        bad = (a.float() != b.float()).sum().item()
                        raise AssertionError(
                            f"pool {kind} {preset} {batch}x{c}x{h}x{w} "
                            f"{dtype}: the kernels' {what} differs from "
                            f"torch's in {bad} elements")
                    if not same_bits(a, r):
                        raise AssertionError(
                            f"pool {kind} {preset} {batch}x{c}x{h}x{w} "
                            f"{dtype}: two runs of the {what} differ")
                del got, again, want
                if dtype != torch.bfloat16:
                    del x, dy
                    continue
                reps = 20 if h * w > 100 else 40
                if kind == "box":
                    fwd = lambda: pool.box3x3_kernel(x)  # noqa: E731
                    bwd = lambda: pool.box3x3_kernel(dy)  # noqa: E731
                else:
                    fwd = lambda: pool.max3x3s2_forward_kernel(x)  # noqa
                    bwd = lambda: pool.max3x3s2_backward_kernel(  # noqa
                        dy, x)
                ms = {"forward": device_ms(fwd, reps),
                      "backward": device_ms(bwd, reps),
                      "plain": device_ms(lambda: plain(kind, x, dy), reps),
                      "library": device_ms(lambda: library(kind, x, dy),
                                           reps),
                      "bound": 2 * 2 * (x.numel() + dy.numel())
                      / H100_BYTES_PER_S * 1e3}
                ms["kernel"] = ms["forward"] + ms["backward"]
                for k in totals:
                    totals[k] += count * ms[k]
                print(f"[pool] {kind} {preset} {batch}x{c}x{h}x{w} (x{count})"
                      f": bit-exact in bf16 and float32, repeat runs equal; "
                      f"bf16 forward {ms['forward']:.4f} ms, backward "
                      f"{ms['backward']:.4f}, floor {ms['bound']:.4f} "
                      f"({100 * ms['bound'] / ms['kernel']:.1f}%), plain "
                      f"{ms['plain']:.4f}, library {ms['library']:.4f}; "
                      f"{card}")
                entries.append(pool_entry(
                    f"pool_{kind}_{preset}_{batch}x{c}x{h}x{w}", kind, ms,
                    count))
                del x, dy
        if calls != 13:
            raise AssertionError(f"{preset}: {calls} pools a pass, not 13")
        entries.append(pool_entry(f"pool_{preset}_{batch}_all13", "both",
                                  totals, 13))
        print(f"[pool] {preset} all 13 pools at {batch}, bf16: kernels "
              f"{totals['kernel']:.3f} ms a step (forward "
              f"{totals['forward']:.3f}, backward {totals['backward']:.3f}),"
              f" floor {totals['bound']:.3f} "
              f"({100 * totals['bound'] / totals['kernel']:.1f}%), plain "
              f"{totals['plain']:.3f}, library {totals['library']:.3f}; "
              f"{card}")
    torch.cuda.empty_cache()
    return entries


def pool_entry(name, kind, ms, pools) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": "deepvariant_tpu_torch/csrc/pool.cu",
        "replaces": None,
        "tpu_kernel": None,
        "launches": None,   # phase 14's train steps
        "kind": kind,
        "pools": pools,
        "max_abs_err": 0.0,
        "ms": ms["kernel"],
        "kernel_ms": ms["kernel"],
        "forward_ms": ms["forward"],
        "backward_ms": ms["backward"],
        "plain_ms": ms["plain"],
        "bound_ms": ms["bound"],
        "bound_by": "bytes",
        "library_ms": ms["library"],
    }


def kernel_entry(name, kernel_ms, plain_ms, bound_ms, bound_by, max_err,
                 **more) -> dict:
    """One entry of the kernels line; `launches` is filled in after the
    entry's path has run."""
    return {
        "name": name,
        "route": "cuda",
        "source": "deepvariant_tpu_torch/csrc/pileup_paint.cu",
        "replaces": "deepvariant_tpu/ops/pileup_paint.py:87",
        "tpu_kernel": "deepvariant_tpu/ops/pileup_paint.py:_paint_kernel",
        "launches": None,
        "max_abs_err": max_err,
        "max_abs_diff": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        **more,
    }


def write_staged_inputs(tmp: str):
    """Synthetic examples, their example_info.json, and a seeded
    checkpoint, all written with the port's own writers."""
    from deepvariant_tpu_torch.core.types import Variant, VariantCall
    from deepvariant_tpu_torch.io import examples
    from deepvariant_tpu_torch.io.tfrecord import TFRecordWriter
    from deepvariant_tpu_torch.make_examples.pileup import WGS_CHANNELS
    from deepvariant_tpu_torch.models.checkpoint import save_variables

    start = time.time()
    rng = np.random.RandomState(SEED)
    path = os.path.join(tmp, "examples.tfrecord")
    with TFRecordWriter(path) as w:
        for i in range(N_EXAMPLES):
            variant = Variant(
                reference_name="chr20", start=10_000 + 3 * i,
                end=10_001 + 3 * i, reference_bases="A",
                alternate_bases=["G"],
                calls=[VariantCall(call_set_name="smoke",
                                   info={"AD": [5, 6], "DP": [11]})])
            image = rng.randint(0, 255, SHAPE, np.uint8)
            w.write(examples.make_example(
                variant, image, [0],
                f"chr20:{10_001 + 3 * i}-{10_002 + 3 * i}"))
    examples.write_example_info(path, SHAPE, WGS_CHANNELS)
    # The timed run reads the file STAGED_REPEATS times as a shard family.
    family = os.path.join(tmp, "repeat")
    for k in range(STAGED_REPEATS):
        os.symlink(path, f"{family}-{k:05d}-of-{STAGED_REPEATS:05d}.tfrecord")
    examples.write_example_info(
        f"{family}-00000-of-{STAGED_REPEATS:05d}.tfrecord", SHAPE,
        WGS_CHANNELS)
    model = seeded_model(SHAPE[2])
    ckpt_dir = os.path.join(tmp, "ckpt")
    save_variables(os.path.join(ckpt_dir, "model.msgpack"), model,
                   {"shape": list(SHAPE), "channels": WGS_CHANNELS})
    seconds = time.time() - start
    print(f"[staged] wrote {N_EXAMPLES} examples and a checkpoint in "
          f"{seconds:.1f} s")
    return path, f"{family}@{STAGED_REPEATS}.tfrecord", ckpt_dir, model


def run_cli(argv):
    """Run the CLI, which must exit 0; returns (examples, examples/s)."""
    from deepvariant_tpu_torch.scripts import call_variants as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    print("[staged] " + text.strip())
    if rc != 0:
        raise AssertionError(f"call_variants CLI exited {rc}")
    m = re.search(r"done: (\d+) examples at ([0-9.]+) examples/s", text)
    return int(m.group(1)), float(m.group(2))


def check_cvos(path: str, expected: int):
    from deepvariant_tpu_torch.calling.call_variants import read_cvos
    from deepvariant_tpu_torch.core.genomics_math import round_gls

    cvos = list(read_cvos(path))
    if len(cvos) != expected:
        raise AssertionError(f"{len(cvos)} CVOs read back, expected "
                             f"{expected}")
    for cvo in cvos:
        p = cvo.genotype_probabilities
        if len(p) != 3 or not all(math.isfinite(x) for x in p) or \
                abs(sum(p) - 1.0) > 1e-9 or round_gls(p) != p:
            raise AssertionError(f"bad probabilities {p} at "
                                 f"{cvo.variant.start}")
    return cvos


def phase_staged(tmp: str, device):
    import torch

    from deepvariant_tpu_torch.calling.call_variants import (
        Predictor,
        iter_examples,
    )

    path, family, ckpt_dir, model = write_staged_inputs(tmp)
    out = os.path.join(tmp, "cvo.tfrecord.gz")
    n, _ = run_cli(["--examples", path, "--outfile", out,
                    "--checkpoint", ckpt_dir, "--batch_size", str(BATCH)])
    check_cvos(out, N_EXAMPLES)
    print(f"[staged] {n} CVOs read back: finite, summing to 1, rounded")
    out2 = os.path.join(tmp, "cvo_repeat.tfrecord.gz")
    n2, rate = run_cli(["--examples", family, "--outfile", out2,
                        "--checkpoint", ckpt_dir, "--batch_size",
                        str(BATCH)])
    check_cvos(out2, N_EXAMPLES * STAGED_REPEATS)

    images = np.stack([r.image for _, r in zip(range(BATCH),
                                               iter_examples([path]))])
    bf16 = Predictor(model, BATCH, device, torch.bfloat16)(images)
    f32 = Predictor(model, BATCH, device, torch.float32)(images)
    agree = float((bf16.argmax(-1) == f32.argmax(-1)).mean())
    max_dp = float(np.abs(bf16 - f32).max())
    print(f"[staged] bf16 vs float32 (TF32 off) on the first batch: argmax "
          f"agreement {agree:.4f}, max |dp| {max_dp:.3g}")
    return {"staged_examples": n2, "staged_examples_per_s": rate,
            "bf16_f32_argmax_agreement": agree,
            "bf16_f32_max_abs_dp": max_dp}, model


def seeded_model(channels: int):
    """InceptionV3 for `channels` planes with weights from SEED, on the
    CPU in float32."""
    import torch

    from deepvariant_tpu_torch.models.inception_v3 import create_model

    model = create_model(channels, dtype=torch.float32, device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        # He scaling keeps the activations' scale through the ReLUs of the
        # random network, so the probabilities are not all 1/3.
        for module in model.modules():
            if isinstance(module, torch.nn.Conv2d):
                module.weight.mul_(2.0 ** 0.5)
    return model


def phase_plans(model, device, options, tag):
    """Returns the timed stream's numbers and the predictor and plans
    for the checks that follow the count read."""
    from deepvariant_tpu_torch.calling.plan_predictor import (
        PlannedExample,
        PlanPredictor,
        compact_plan,
    )
    from deepvariant_tpu_torch.core.types import Variant

    diff_mode = options.alt_aligned_pileup == "diff_channels"
    # Plans come as the planner makes them, alt tensors and all; without
    # diff mode they are stripped as the stream's workers strip them.
    plans = [compact_plan(p, diff_mode) for p in random_plans(
        N_PLANS, SEED + 1, options.max_reads, options.width, alt=True)]
    payloads = [PlannedExample(p, Variant(start=i), [0], 1)
                for i, p in enumerate(plans)]
    predictor = PlanPredictor(model, options, batch_size=BATCH,
                              device=device)
    for _ in predictor.predict_plan_stream(payloads):  # warm-up pass
        pass
    start = time.time()
    results = list(predictor.predict_plan_stream(payloads))
    seconds = time.time() - start
    probs = np.stack([p for _, p in results])
    if probs.shape != (N_PLANS, 3) or not np.isfinite(probs).all() or \
            np.abs(probs.sum(-1) - 1).max() > 1e-5:
        raise AssertionError(f"{tag} plan path probabilities are malformed")
    print(f"[{tag}] {N_PLANS} plans in {seconds:.3f} s: "
          f"{N_PLANS / seconds:.1f} plans/s")
    return {"plans": N_PLANS, "plans_per_s": N_PLANS / seconds}, \
        predictor, plans, probs


def check_plan_path(predictor, plans, probs, device, tag):
    """The fused images equal the plain painter's on the same plans, and
    the fused probabilities equal the staged Predictor's on them."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import Predictor
    from deepvariant_tpu_torch.make_examples.pileup_device import (
        ALT_KEYS,
        PLAN_KEYS,
        make_longread_encode_fn,
    )

    o = predictor.options
    batch = plans[:BATCH]       # the first batch, which may not be full
    images = predictor.encode(batch).cpu()[:len(batch)]
    keys = PLAN_KEYS + (ALT_KEYS if predictor.diff_mode else ())
    plain = make_longread_encode_fn(o)(*stack_plans(batch, keys, "cpu"))
    shape = (len(batch), o.height, o.width,
             predictor.predictor.model.num_channels)
    if tuple(images.shape) != shape or not torch.equal(images, plain):
        raise AssertionError(f"{tag}: fused images {tuple(images.shape)} "
                             "differ from the plain painter")
    staged = Predictor(predictor.predictor.model, BATCH, device,
                       torch.bfloat16)(images.numpy())
    if not np.array_equal(staged, probs[:len(batch)]):
        raise AssertionError(
            f"{tag}: fused probabilities differ from Predictor on the same "
            "images (max "
            f"{float(np.abs(staged - probs[:len(batch)]).max()):.3g})")
    print(f"[{tag}] fused images {shape} == plain painter; fused "
          "probabilities == Predictor on those images")


def time_device_steps(predictor, plans, model, device, tag) -> dict:
    """Time per batch of each step of the fused path (CUDA events, inputs
    already on the card): the painter and the CNN, each as single calls
    (`*_ms`, the host's launches included) and back to back on the card
    (`*_device_ms`), and the CNN with --fast_graph's folded BN and
    8-channel stem (where the model has fewer than 8 channels)."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import Predictor

    staged = predictor.stage(plans[:BATCH])
    args = list(staged.values())
    images = predictor.encode_fn(*args)
    with torch.inference_mode():
        steps = {
            "paint_step_ms": time_ms(lambda: predictor.encode_fn(*args)),
            "paint_step_device_ms": device_ms(
                lambda: predictor.encode_fn(*args)),
            "cnn_ms": time_ms(lambda: predictor.predictor.forward(images),
                              reps=10),
            # The same forward queued behind a spin kernel: the card's
            # time alone, without the host's launches of its kernels.
            "cnn_device_ms": device_ms(
                lambda: predictor.predictor.forward(images), reps=3),
        }
        if model.num_channels < 8:
            fast = Predictor(model, BATCH, device, torch.bfloat16,
                             fold_bn=True, pad_stem_to=8)
            steps["cnn_fast_graph_ms"] = time_ms(
                lambda: fast.forward(images), reps=10)
    print(f"[{tag}] per batch of {BATCH} on the card: " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    return steps


def synthetic_region(seed: int, n_reads: int = 240, span: int = 400):
    """Reads with M, I, D, N, S and H in their CIGARs on both strands,
    some paired, tagged and supplementary, and four candidates over
    them: (ReadBatch, [DeepVariantCall], [alt alleles], reference)."""
    from deepvariant_tpu_torch.core.cigar import parse_cigar_string, read_span
    from deepvariant_tpu_torch.core.types import Read, Variant
    from deepvariant_tpu_torch.io.bam import ReadBatch
    from deepvariant_tpu_torch.make_examples.variant_caller import (
        DeepVariantCall,
    )

    rng = np.random.RandomState(seed)
    reference = np.frombuffer(b"ACGT", np.uint8)[rng.randint(0, 4, span)]
    cigars = ["60M", "20M2I38M", "5S25M3D30M", "30M40N30M", "3H57M2S",
              "10M1I10M1D10M5N29M"]
    reads = []
    for i in range(n_reads):
        cigar = parse_cigar_string(cigars[i % len(cigars)])
        length = read_span(cigar)
        paired = bool(i % 3)
        reads.append(Read(
            fragment_name=f"read{i // 2:03d}",
            aligned_sequence="".join("ACGT"[b] for b in rng.randint(
                0, 4, length)),
            aligned_quality=bytes(rng.randint(0, 61, length).tolist()),
            reference_name="chr1", position=int(rng.randint(0, span - 120)),
            mapping_quality=int(rng.randint(0, 71)), cigar=cigar,
            reverse_strand=bool(rng.randint(2)),
            read_number=i % 2 if paired else 0,
            number_reads=2 if paired else 1,
            fragment_length=int(rng.randint(-1500, 1500)),
            supplementary_alignment=i % 7 == 0,
            info={"HP": [int(rng.randint(0, 3))]}))
    batch = ReadBatch.from_reads(reads, ["chr1"])
    calls, combos = [], []
    for start in (5, 130, 200, span - 10):
        variant = Variant(reference_name="chr1", start=start, end=start + 1,
                          reference_bases="A", alternate_bases=["C", "AT"])
        picked = rng.permutation(n_reads)
        calls.append(DeepVariantCall(
            variant=variant,
            allele_support={"C": sorted(picked[:15].tolist()),
                            "AT": sorted(picked[15:25].tolist())},
            allele_frequencies={"C": 0.31, "AT": 0.002}))
        combos.append(["C"] if start % 2 else ["C", "AT"])
    return batch, calls, combos, reference


def phase_region_encoder(device):
    """encode_region_candidates on the card equals the same call on the
    CPU (its plain version), over synthetic reads and windows that hang
    off both ends of the reference."""
    from deepvariant_tpu_torch.make_examples.pileup import (
        PileupEncoder,
        PileupOptions,
        reads_overlapping_variant,
    )
    from deepvariant_tpu_torch.make_examples.pileup_device import (
        encode_region_candidates,
    )

    batch, calls, combos, reference = synthetic_region(SEED + 3)
    options = PileupOptions(channels=ALL_DEVICE_CHANNELS, width=99,
                            height=40, sort_by_haplotypes=True)
    encoder = PileupEncoder(options)

    def ref_query(variant):
        cols = np.arange(options.width) + variant.start - options.half_width
        window = reference[np.clip(cols, 0, len(reference) - 1)].copy()
        window[(cols < 0) | (cols >= len(reference))] = ord("N")
        return window

    on_card = encode_region_candidates(encoder, calls, combos, batch,
                                       ref_query, device=device)
    on_cpu = encode_region_candidates(encoder, calls, combos, batch,
                                      ref_query, device="cpu")
    shape = (len(calls), options.height, options.width,
             len(options.channels))
    if on_card.shape != shape or not np.array_equal(on_card, on_cpu):
        raise AssertionError("encode_region_candidates on the card differs "
                             "from the CPU")
    rows = int((on_cpu[:, options.reference_band_height:, :, 0] != 0)
               .any(-1).sum())
    crowded = sum(len(reads_overlapping_variant(batch, c.variant))
                  > options.max_reads for c in calls)
    if rows == 0 or crowded == 0:
        raise AssertionError(
            f"the synthetic region painted {rows} read rows and shuffled "
            f"{crowded} crowded windows; both must happen")
    print(f"[region] encode_region_candidates {shape} on the card == CPU "
          f"({rows} read rows painted, {crowded} of {len(calls)} windows "
          "crowded)")


def locus_key(variant, alt_indices) -> tuple:
    return (variant.reference_name, variant.start, variant.end,
            tuple(alt_indices))


def variant_bytes(variant) -> bytes:
    """The variant's wire bytes without its phase-set region label
    (PS_CONTIG, "task-region number"): a stream worker numbers its own
    shard's regions, the one runner process all of them."""
    info = variant.info
    if "PS_CONTIG" not in info:
        return variant.encode()
    variant.info = {k: v for k, v in info.items() if k != "PS_CONTIG"}
    try:
        return variant.encode()
    finally:
        variant.info = info


def write_sample_files(sample, directory: str, tag: str) -> dict:
    """The sample's FASTA and indexed BAM, written with the port's own
    writers; returns their paths."""
    from deepvariant_tpu_torch.core import types
    from deepvariant_tpu_torch.io import bam, bam_writer
    from deepvariant_tpu_torch.testing import synthetic

    start = time.time()
    paths = synthetic.write_inputs(sample, directory, types, bam, bam_writer)
    print(f"[{tag}] wrote {sum(n for _, n in sample['contigs'])} reference "
          f"bases and {len(sample['reads']['name'])} reads "
          f"({os.path.getsize(paths['reads'])} BAM bytes, indexed) in "
          f"{time.time() - start:.1f} s")
    return paths


def run_runner(options, tmp: str, tag: str, card: str, least_plans: int):
    """`make_examples_runner` with a plan sink, in this process. Returns
    (kept plans, numbers: counts, seconds, seconds by stage)."""
    from deepvariant_tpu_torch.make_examples.core import make_examples_runner

    kept = []
    tsv = os.path.join(tmp, f"{tag}.runtime_by_region.tsv")
    options.candidates_filename = os.path.join(tmp,
                                               f"{tag}.candidates.tfrecord")
    start = time.time()
    counts = make_examples_runner(options, runtime_by_region_path=tsv,
                                  plan_sink=kept.append)
    runner_s = time.time() - start
    with open(tsv) as f:
        header, *rows = [line.rstrip("\n").split("\t") for line in f]
    stage_s = {name: sum(float(r[i]) for r in rows)
               for i, name in enumerate(header) if i and name != "total"}
    if counts["examples"] != len(kept) or len(kept) < least_plans:
        raise AssertionError(
            f"{tag}: the runner made {len(kept)} plans (counts {counts}); "
            f"the phase needs at least {least_plans}")
    print(f"[{tag}] make_examples_runner, one worker in process: "
          f"{counts['candidates']} candidates and {len(kept)} plans from "
          f"{len(rows)} regions in {runner_s:.2f} s: "
          f"{counts['candidates'] / runner_s:.1f} candidates/s, "
          f"{len(kept) / runner_s:.1f} plans/s; seconds by stage "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_s.items())
          + f"; host CPUs {os.cpu_count()}, beside {card}")
    return kept, {"candidates": counts["candidates"], "plans": len(kept),
                  "one_worker_s": runner_s,
                  "one_worker_candidates_per_s":
                      counts["candidates"] / runner_s,
                  "one_worker_plans_per_s": len(kept) / runner_s,
                  "one_worker_stage_s": stage_s}


def run_stream(options, kept, predictor, device, card: str, tag: str,
               vcf: str = "", ref: str = "", sample_name: str = "",
               gvcf: str = ""):
    """`stream_examples_to_cvos(device_encode=True)` with STREAM_WORKERS
    spawned workers on the card, between a zeroed and a read launch
    count, held against the plans the runner kept: as many CVOs, the same
    variants and alt indices, probabilities equal to `predictor` on the
    kept plans batched in the stream's order, the first batch's images
    equal to the plain painter, one launch of the plan form per batch.
    With `vcf`, the stream runs inside `run_streaming_pipeline`, which
    goes on to write that VCF from `ref`'s contigs (and with `gvcf` that
    gVCF, from the gVCF records the workers sent); the CVOs it handed to
    stage 3 are kept (copied before stage 3 writes calls into them).
    Returns (numbers, launches, the kept plans in the stream's order, the
    CVOs)."""
    from deepvariant_tpu_torch.core.genomics_math import round_gls
    from deepvariant_tpu_torch.ops import pileup_paint as pp
    from deepvariant_tpu_torch.parallel import stream_pipeline

    cpus = os.cpu_count()
    numbers = {}
    pp.paint_pileup.launches = 0
    if vcf:
        seen, restore = record_stream_cvos()
        start = time.time()
        try:
            result = stream_pipeline.run_streaming_pipeline(
                options, vcf, ref, sample_name=sample_name,
                num_workers=STREAM_WORKERS, batch_size=BATCH,
                device_encode=True,
                plan_predictor_factory=lambda: predictor, output_gvcf=gvcf,
                device=device)
        finally:
            restore()
        to_vcf_s = time.time() - start
        (cvos, stats), = seen
        numbers.update({
            "to_vcf_s": to_vcf_s,
            "to_vcf_examples_per_s": len(cvos) / to_vcf_s,
            "pipeline_postprocess_s": to_vcf_s - stats.wall_seconds,
            "vcf_records": result["postprocess"]["vcf_records"],
            "gvcf_records": result["postprocess"]["gvcf_records"],
            "stream_gvcf_records": stats.num_gvcf_records})
        print(f"[{tag}] run_streaming_pipeline to {os.path.basename(vcf)}"
              + (f" and {os.path.basename(gvcf)} "
                 f"({result['postprocess']['gvcf_records']} gVCF records "
                 f"from {stats.num_gvcf_records} reference blocks)"
                 if gvcf else "") + ": "
              f"{result['postprocess']['vcf_records']} records from "
              f"{len(cvos)} CVOs in {to_vcf_s:.2f} s, "
              f"{numbers['to_vcf_examples_per_s']:.1f} examples/s from the "
              f"BAM to the VCF (the stream {stats.wall_seconds:.2f} s, stage "
              f"3 {numbers['pipeline_postprocess_s']:.2f} s); {card}; host "
              f"CPUs {cpus}")
    else:
        cvos, stats, _ = stream_pipeline.stream_examples_to_cvos(
            options, STREAM_WORKERS, batch_size=BATCH, device_encode=True,
            plan_predictor_factory=lambda: predictor, device=device)
    launches = pp.paint_pileup.launches
    batches = -(-len(cvos) // BATCH)
    print(f"[{tag}] {len(cvos)} CVOs from files with {STREAM_WORKERS} "
          f"workers in {stats.wall_seconds:.2f} s: "
          f"{stats.examples_per_sec:.1f} examples/s "
          f"({stats.steady_state_examples_per_sec:.1f} from the first "
          f"batch on); {launches} launches of the plan form for {batches} "
          f"batches; {card}; host CPUs {cpus}")
    if len(cvos) != len(kept) or stats.num_examples != len(kept):
        raise AssertionError(f"{tag}: {len(cvos)} CVOs for {len(kept)} plans")
    if launches != batches:
        raise AssertionError(f"{tag}: {launches} launches of the plan form "
                             f"for {batches} batches")
    by_locus = {locus_key(p.variant, p.alt_indices): p for p in kept}
    if len(by_locus) != len(kept):
        raise AssertionError(f"{tag}: two plans share a locus and alt indices")
    # The kept plans in the stream's order of arrival: the same batches.
    ordered = []
    for cvo in cvos:
        planned = by_locus.get(locus_key(cvo.variant, cvo.alt_allele_indices))
        if planned is None or \
                variant_bytes(planned.variant) != variant_bytes(cvo.variant):
            raise AssertionError(
                f"{tag}: the stream's CVO at {cvo.variant.reference_name}:"
                f"{cvo.variant.start} is not among the runner's plans")
        ordered.append(planned.plan)
    if sorted(locus_key(c.variant, c.alt_allele_indices) for c in cvos) != \
            sorted(by_locus):
        raise AssertionError(f"{tag}: the stream's loci differ from the "
                             "runner's")
    probs = np.concatenate([predictor(ordered[i:i + BATCH])
                            for i in range(0, len(ordered), BATCH)])
    for cvo, p in zip(cvos, probs):
        if cvo.genotype_probabilities != round_gls([float(x) for x in p]):
            raise AssertionError(
                f"{tag}: stream probabilities {cvo.genotype_probabilities} "
                f"differ from PlanPredictor's {p} at {cvo.variant.start}")
    if not np.isfinite(probs).all():
        raise AssertionError(f"{tag}: stream probabilities are not finite")
    print(f"[{tag}] as many CVOs as plans, the same variants and alt "
          f"indices, probabilities == PlanPredictor on the kept plans "
          f"({sum(len(c.alt_allele_indices) == 2 for c in cvos)} "
          "two-alt examples)")
    check_plan_path(predictor, ordered, probs, device, tag)
    numbers.update({"workers": STREAM_WORKERS,
                    "examples_per_s": stats.examples_per_sec,
                    "steady_examples_per_s":
                        stats.steady_state_examples_per_sec,
                    "wall_s": stats.wall_seconds, "batches": batches})
    return numbers, launches, ordered, cvos


def vcf_records(path: str) -> list:
    """The record lines of a plain or BGZF VCF."""
    from deepvariant_tpu_torch.io.bgzf import BgzfReader

    if path.endswith(".gz"):
        with BgzfReader(path) as reader:
            text = reader.read_all().decode()
    else:
        with open(path) as f:
            text = f.read()
    return [line for line in text.splitlines()
            if line and not line.startswith("#")]


def check_vcf(vcf: str, cvos, ref: str, sample_name: str, tag: str,
              card: str, **options) -> dict:
    """The VCF against stage 3 on the same CVOs in memory (with
    `options` of postprocess_variants, as the route gave them): the same
    bytes, one record per CVO group (none is filtered out at the
    defaults), and a working `.tbi` (built here where the route did not
    build one). Returns the in-memory postprocess's numbers."""
    from deepvariant_tpu_torch.core.types import CallVariantsOutput
    from deepvariant_tpu_torch.io.fasta import FastaReader
    from deepvariant_tpu_torch.io.tabix import TabixReader, build_index
    from deepvariant_tpu_torch.postprocess.pipeline import (
        group_cvos,
        postprocess_variants,
    )

    contigs = FastaReader(ref).contigs
    again = vcf.replace(".vcf", ".in_memory.vcf")
    copies = [CallVariantsOutput.decode(c.encode()) for c in cvos]
    start = time.time()
    stats = postprocess_variants(copies, again, contigs,
                                 sample_name=sample_name, **options)
    seconds = time.time() - start
    with open(vcf, "rb") as a, open(again, "rb") as b:
        if a.read() != b.read():
            raise AssertionError(f"{tag}: {vcf} differs from "
                                 "postprocess_variants on the same CVOs in "
                                 "memory")
    order = {c.name: i for i, c in enumerate(contigs)}
    groups = list(group_cvos(sorted(
        cvos, key=lambda c: (order[c.variant.reference_name],
                             c.variant.start, c.variant.end))))
    records = vcf_records(vcf)
    starts = [(line.split("\t")[0], int(line.split("\t")[1]) - 1)
              for line in records]
    if len(records) != len(groups) or stats["vcf_records"] != len(groups) \
            or starts != [(g[0].variant.reference_name, g[0].variant.start)
                          for g in groups]:
        raise AssertionError(
            f"{tag}: {len(records)} VCF records for {len(groups)} CVO groups")
    if not os.path.exists(vcf + ".tbi"):
        build_index(vcf)
    # A region around the middle record: the index must return exactly
    # the records that overlap it.
    name, pos = starts[len(starts) // 2]
    lo, hi = max(0, pos - 700), pos + 700
    want = [line for line, (c, p) in zip(records, starts)
            if c == name and p < hi and
            p + len(line.split("\t")[3]) > lo]
    got = list(TabixReader(vcf).query(name, lo, hi))
    if got != want or not got:
        raise AssertionError(f"{tag}: the .tbi returned {len(got)} records "
                             f"for {name}:{lo}-{hi}, the VCF has "
                             f"{len(want)} there")
    print(f"[{tag}] {os.path.basename(vcf)} == postprocess_variants on the "
          f"same CVOs in memory; {len(records)} records for {len(groups)} "
          f"CVO groups; the .tbi returns the {len(got)} records of "
          f"{name}:{lo}-{hi}; stage 3 in memory {seconds:.3f} s, "
          f"{len(records) / seconds:.1f} records/s "
          f"({len(cvos) / seconds:.1f} CVOs/s); host CPUs {os.cpu_count()}, "
          f"beside {card}")
    return {"vcf_records": len(records), "postprocess_s": seconds,
            "postprocess_records_per_s": len(records) / seconds,
            "tbi_query_records": len(got)}


def from_files_entry(name: str, predictor, ordered, tag: str,
                     card: str) -> dict:
    """The kernels-line entry of a from-files path: the plan form on the
    path's own first batch of plans, as the predictor stages it (padded
    to BATCH), against its plain version on the card, timed, with the
    bound of these tensors."""
    import torch

    from deepvariant_tpu_torch.make_examples.pileup_device import (
        ALT_KEYS,
        PLAN_KEYS,
    )
    from deepvariant_tpu_torch.ops import pileup_paint as pp

    staged = predictor.stage(ordered[:BATCH])
    colors = predictor.encode_fn.colors
    read_args = [staged[k] for k in PLAN_KEYS + (
        ALT_KEYS if predictor.diff_mode else ())]
    args = read_args + [None] * (len(PLAN_KEYS + ALT_KEYS) - len(read_args))
    with torch.inference_mode():
        out = pp.paint_pileup_plan(*args, colors)
        plain = pp.paint_pileup_plan_reference(*args, colors)
        torch.cuda.synchronize()
        err = int((out.int() - plain.int()).abs().max())
        if out.shape != plain.shape or not torch.equal(out, plain):
            raise AssertionError(
                f"{tag}: the plan form differs from its plain version on "
                f"this path's plans (max abs err {err})")
        bound_ms, bound_by = bound(read_args, out)
        kernel_ms = device_ms(lambda: pp.paint_pileup_plan(*args, colors))
        plain_ms = device_ms(
            lambda: pp.paint_pileup_plan_reference(*args, colors), reps=10)
    print(f"[{tag}] plan form on this path's plans at {tuple(out.shape)} == "
          f"plain; kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}): {bound_ms / kernel_ms:.1%} of the "
          f"bound; {card}")
    return kernel_entry(name, kernel_ms, plain_ms, bound_ms, bound_by, err)


def postprocess_cli(cvos, ref: str, directory: str, tag: str,
                    card: str) -> dict:
    """The stream's CVOs written to a TFRecord and postprocessed by the
    port's CLI (`scripts/postprocess_variants.py` `main`) into a
    `.vcf.gz` with its `.tbi`, then held by `check_vcf`. Returns the
    numbers of both stage-3 runs."""
    from deepvariant_tpu_torch.io.tfrecord import TFRecordWriter
    from deepvariant_tpu_torch.scripts import postprocess_variants as cli

    cvo_path = os.path.join(directory, "cvo.tfrecord.gz")
    start = time.time()
    with TFRecordWriter(cvo_path) as writer:
        for cvo in cvos:
            writer.write(cvo.encode())
    write_s = time.time() - start
    vcf = os.path.join(directory, "calls.vcf.gz")
    buf = io.StringIO()
    start = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--ref", ref, "--infile", cvo_path, "--outfile", vcf])
    seconds = time.time() - start
    print(f"[{tag}] postprocess_variants CLI: {buf.getvalue().strip()} in "
          f"{seconds:.3f} s, .tbi written: {os.path.exists(vcf + '.tbi')}; "
          f"host CPUs {os.cpu_count()}, beside {card}")
    if rc != 0:
        raise AssertionError(f"{tag}: postprocess_variants CLI exited {rc}")
    numbers = check_vcf(vcf, cvos, ref, cli._sample_name_from_cvos(cvo_path),
                        tag, card)
    numbers.update({"cvo_write_s": write_s, "cli_s": seconds,
                    "cli_records_per_s": numbers["vcf_records"] / seconds})
    return numbers


def phase_stream(tmp: str, model, device, card: str):
    """Phase 7: the WGS preset from files, realigner off. Returns
    (numbers, launches of the plan form on the stream path)."""
    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.io import bam, bgzf
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.presets import apply_model_preset
    from deepvariant_tpu_torch.testing import synthetic

    cpus = os.cpu_count()
    sample = synthetic.synthetic_sample(SEED + 7, STREAM_CONTIGS)
    paths = write_sample_files(sample, os.path.join(tmp, "files"), "files")

    start = time.time()
    with bgzf.BgzfReader(paths["reads"]) as raw:
        inflated = len(raw.read_all())
    inflate_s = time.time() - start
    start = time.time()
    with bam.BamReader(paths["reads"]) as reader:
        n_decoded = len(reader.iterate())
    decode_s = time.time() - start
    reads_per_s = n_decoded / decode_s
    print(f"[files] BamReader.iterate: {n_decoded} reads decoded (BGZF "
          f"inflate and the Python record decoder) in {decode_s:.2f} s: "
          f"{reads_per_s:.1f} reads/s; the inflate alone "
          f"(BgzfReader.read_all, {inflated} bytes) {inflate_s:.2f} s; "
          f"host CPUs {cpus}, beside {card}")

    def options():
        # The realigner stays off here: phase 8 turns it on.
        return apply_model_preset(MakeExamplesOptions(
            reads_filename=paths["reads"], ref_filename=paths["ref"],
            realigner_enabled=False), "WGS")

    print("[files] WGS preset with realigner_enabled=False")
    kept, runner = run_runner(options(), tmp, "files", card, 2 * BATCH)
    predictor = PlanPredictor(model, options().pileup_options,
                              batch_size=BATCH, device=device)
    stream, launches, _, _ = run_stream(options(), kept, predictor, device,
                                        card, "stream")
    numbers = {
        "stream_reads": n_decoded, "stream_reads_decoded_per_s": reads_per_s,
        "stream_candidates": runner["candidates"],
        "stream_plans": runner["plans"],
        "stream_one_worker_candidates_per_s":
            runner["one_worker_candidates_per_s"],
        "stream_one_worker_plans_per_s": runner["one_worker_plans_per_s"],
        "stream_one_worker_stage_s": runner["one_worker_stage_s"],
        "stream_workers": STREAM_WORKERS,
        "stream_examples_per_s": stream["examples_per_s"],
        "stream_steady_examples_per_s": stream["steady_examples_per_s"],
        "stream_wall_s": stream["wall_s"], "host_cpus": cpus,
        "stream_inflate_s": inflate_s, "stream_decode_s": decode_s,
    }
    return numbers, launches


def plans_equal(a, b) -> bool:
    """Two lists of PlannedExamples equal bit for bit: the variants'
    bytes, the alt indices, the labels, and every tensor of the plans
    with its dtype and shape."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if variant_bytes(x.variant) != variant_bytes(y.variant) or \
                x.alt_indices != y.alt_indices or x.label != y.label or \
                list(x.plan) != list(y.plan):
            return False
        for k in x.plan:
            if x.plan[k].dtype != y.plan[k].dtype or \
                    not np.array_equal(x.plan[k], y.plan[k]):
                return False
    return True


def phase_realigned_stream(tmp: str, model, device, card: str):
    """Phase 8: the WGS preset with its defaults, realigner on. Returns
    (numbers, the path's kernels-line entry with its launches)."""
    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.presets import apply_model_preset
    from deepvariant_tpu_torch.realign import realigner as realigner_module
    from deepvariant_tpu_torch.testing import synthetic

    tag = "realign"
    kb = sum(n for _, n in REALIGN_CONTIGS) / 1000
    sample = synthetic.synthetic_sample(
        SEED + 8, REALIGN_CONTIGS, variant_spacing=REALIGN_VARIANT_SPACING)
    paths = write_sample_files(sample, os.path.join(tmp, tag), tag)
    print(f"[{tag}] WGS preset with its defaults (realigner on); a variant "
          f"planted every {REALIGN_VARIANT_SPACING}-"
          f"{REALIGN_VARIANT_SPACING * 5 // 4} bases, so that the selector's "
          "windows stay narrower than max_window_size and assemble")

    def options(**more):
        return apply_model_preset(MakeExamplesOptions(
            reads_filename=paths["reads"], ref_filename=paths["ref"],
            **more), "WGS")

    if not options().realigner_enabled:
        raise AssertionError("the WGS preset left the realigner off")
    # Count what the realigner does during the in-process run.
    tally = {"regions": 0, "windows": 0, "reads": 0, "changed": 0}
    plain_realign = realigner_module.Realigner.realign_reads

    def counted_realign(self, reads, region, batch=None):
        haplotypes, realigned = plain_realign(self, reads, region,
                                              batch=batch)
        given = {id(r) for r in reads}
        tally["regions"] += 1
        tally["windows"] += len(haplotypes)
        tally["reads"] += len(reads)
        # The aligner hands back the read it was given where nothing
        # changed, and a new one where the position or the CIGAR did.
        tally["changed"] += sum(id(r) not in given for r in realigned)
        return haplotypes, realigned

    realigner_module.Realigner.realign_reads = counted_realign
    try:
        kept, runner = run_runner(options(), tmp, tag, card, 16)
    finally:
        realigner_module.Realigner.realign_reads = plain_realign
    stage_s = runner["one_worker_stage_s"]
    share = stage_s["realignment"] / sum(stage_s.values())
    print(f"[{tag}] the realigner assembled {tally['windows']} windows in "
          f"{tally['regions']} regions ({tally['windows'] / kb:.2f} per kb) "
          f"and changed the alignment of {tally['changed']} of "
          f"{tally['reads']} reads ({tally['changed'] / kb:.2f} per kb); "
          f"realignment {stage_s['realignment']:.2f} s, "
          f"{stage_s['realignment'] / kb:.3f} s per kb, {share:.1%} of the "
          f"worker's staged time; host CPUs {os.cpu_count()}, beside {card}")
    if tally["changed"] == 0 or tally["windows"] == 0:
        raise AssertionError(f"{tag}: no window assembled or no read "
                             f"realigned ({tally})")
    if stage_s["realignment"] <= 0:
        raise AssertionError(f"{tag}: the realignment column is empty")
    off, _ = run_runner(options(realigner_enabled=False), tmp, tag + "-off",
                        card, 16)
    if plans_equal(kept, off):
        raise AssertionError(f"{tag}: the plans equal the realigner-off "
                             "run's")
    print(f"[{tag}] with the realigner off the runner makes {len(off)} "
          f"plans, with it {len(kept)}; they differ")
    predictor = PlanPredictor(model, options().pileup_options,
                              batch_size=BATCH, device=device)
    stream, launches, ordered, cvos = run_stream(options(), kept, predictor,
                                                 device, card, tag)
    vcf = postprocess_cli(cvos, paths["ref"], os.path.join(tmp, tag), tag,
                          card)
    to_vcf_s = stream["wall_s"] + vcf["cvo_write_s"] + vcf["cli_s"]
    vcf.update({"to_vcf_s": to_vcf_s,
                "to_vcf_examples_per_s": len(cvos) / to_vcf_s})
    print(f"[{tag}] from the BAM to the VCF: the stream {stream['wall_s']:.2f}"
          f" s, the CVO file {vcf['cvo_write_s']:.3f} s, the CLI "
          f"{vcf['cli_s']:.3f} s: {vcf['to_vcf_examples_per_s']:.1f} "
          f"examples/s; {card}; host CPUs {os.cpu_count()}")
    entry = from_files_entry("pileup_paint_plan_from_files_realigned",
                             predictor, ordered, tag, card)
    entry["launches"] = launches
    numbers = {f"realign_{k}": v for part in (runner, stream, vcf)
               for k, v in part.items()}
    numbers.update({
        "realign_kb": kb, "realign_windows": tally["windows"],
        "realign_reads": tally["reads"],
        "realign_reads_changed": tally["changed"],
        "realign_share_of_worker": share,
        "realign_plans_realigner_off": len(off)})
    return numbers, entry


def phase_longread_stream(tmp: str, model, device, card: str):
    """Phase 9: long reads from files, the PACBIO preset with its
    defaults (direct read phasing on) and phase info on the candidates,
    in diff mode, through `run_streaming_pipeline` to a `.vcf.gz`.
    Returns (numbers, the path's kernels-line entry with its
    launches)."""
    import torch

    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.make_examples import core
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.presets import apply_model_preset
    from deepvariant_tpu_torch.phasing.direct_phasing import DirectPhasing
    from deepvariant_tpu_torch.testing import synthetic

    tag = "longread-files"
    start = time.time()
    sample = synthetic.synthetic_longread_sample(SEED + 9, LONGREAD_CONTIGS)
    print(f"[{tag}] made the long-read sample in {time.time() - start:.1f} s")
    directory = os.path.join(tmp, tag)
    paths = write_sample_files(sample, directory, tag)

    def options():
        return apply_model_preset(MakeExamplesOptions(
            reads_filename=paths["reads"], ref_filename=paths["ref"],
            output_phase_info=True), "PACBIO")

    if not options().phase_reads:
        raise AssertionError("the PACBIO preset left phase_reads off")
    print(f"[{tag}] PACBIO preset with its defaults (phase_reads on, HP "
          "tags of the BAM not read) and output_phase_info")
    # Count what direct phasing does during the in-process run.
    tally = {"calls": 0, "reads": 0, "phased": 0, "phase_s": 0.0}
    plain_phase = DirectPhasing.phase_reads
    plain_process = core.RegionProcessor.process

    def counted_phase(self, candidates, num_reads):
        phases = plain_phase(self, candidates, num_reads)
        tally["calls"] += 1
        tally["reads"] += num_reads
        tally["phased"] += sum(p != 0 for p in phases)
        return phases

    def timed_process(self, region):
        outputs = plain_process(self, region)
        tally["phase_s"] += outputs.runtimes.get("phase reads", 0.0)
        return outputs

    DirectPhasing.phase_reads = counted_phase
    core.RegionProcessor.process = timed_process
    try:
        kept, runner = run_runner(options(), tmp, tag, card, 16)
    finally:
        DirectPhasing.phase_reads = plain_phase
        core.RegionProcessor.process = plain_process
    worker_s = sum(runner["one_worker_stage_s"].values()) + tally["phase_s"]
    print(f"[{tag}] direct phasing in {tally['calls']} regions gave "
          f"{tally['phased']} of {tally['reads']} reads a phase; phase reads "
          f"{tally['phase_s']:.3f} s of the worker's {worker_s:.2f} s of "
          f"stages; host CPUs {os.cpu_count()}, beside {card}")
    if tally["phased"] == 0:
        raise AssertionError(f"{tag}: direct phasing gave no read a phase")
    present = sum(bool(p.plan["alt_present"].any()) for p in kept)
    rows = sum(int(p.plan["alt_row_valid"].sum()) for p in kept)
    print(f"[{tag}] {present} of {len(kept)} plans carry alt-aligned rows "
          f"({rows} rows of reads realigned to an alt haplotype)")
    if present == 0 or rows == 0:
        raise AssertionError(f"{tag}: no plan has alt_present set")
    # The seeded weights give nearly uniform probabilities on these
    # pileups (about 0.29, 0.36, 0.35), so whether het or hom-alt wins
    # flips with the device's rounding (every call het on the CPU,
    # none on the card). A phase set needs a het call: the head's het
    # bias is raised by HET_BIAS, far above that spread.
    model = copy.deepcopy(model)
    with torch.no_grad():
        model.classification.bias[1] += HET_BIAS
    predictor = PlanPredictor(model, options().pileup_options,
                              batch_size=BATCH, device=device)
    if not predictor.diff_mode:
        raise AssertionError(f"{tag}: the predictor is not in diff mode")
    vcf = os.path.join(directory, "calls.vcf.gz")
    stream, launches, ordered, cvos = run_stream(
        options(), kept, predictor, device, card, tag, vcf=vcf,
        ref=paths["ref"], sample_name=sample["sample_name"])
    # The HP plane of the painted images carries the computed phases.
    hp_plane = list(options().pileup_options.channels).index(7)
    with torch.inference_mode():
        hp_pixels = sum(
            int((predictor.encode(ordered[i:i + BATCH])[..., hp_plane] != 0)
                .sum()) for i in range(0, len(ordered), BATCH))
    print(f"[{tag}] the HP plane of the painted images has {hp_pixels} "
          "non-zero pixels")
    if hp_pixels == 0:
        raise AssertionError(f"{tag}: the HP plane is all zero")
    checked = check_vcf(vcf, cvos, paths["ref"], sample["sample_name"], tag,
                        card)
    records = vcf_records(vcf)
    phased = [line for line in records
              if "PS" in line.split("\t")[8].split(":")]
    genotypes = {}
    for line in records:
        gt = line.split("\t")[9].split(":")[0]
        genotypes[gt] = genotypes.get(gt, 0) + 1
    print(f"[{tag}] {len(phased)} of {checked['vcf_records']} VCF records "
          f"carry a phase set (PS); genotypes {sorted(genotypes.items())}")
    if not phased:
        raise AssertionError(f"{tag}: the VCF carries no PS field")
    entry = from_files_entry("pileup_paint_plan_longread_from_files",
                             predictor, ordered, tag, card)
    entry["launches"] = launches
    numbers = {f"longread_files_{k}": v for part in (runner, stream, checked)
               for k, v in part.items()}
    numbers.update({"longread_files_plans_with_alt": present,
                    "longread_files_kb":
                        sum(n for _, n in LONGREAD_CONTIGS) / 1000,
                    "longread_files_phase_reads_s": tally["phase_s"],
                    "longread_files_reads_phased": tally["phased"],
                    "longread_files_reads_in_phased_regions": tally["reads"],
                    "longread_files_hp_pixels": hp_pixels,
                    "longread_files_vcf_records_with_ps": len(phased)})
    return numbers, entry


def gvcf_spans(lines) -> list:
    """(contig, start, end, is reference block) of gVCF record lines; a
    record's end is its END where it has one."""
    out = []
    for line in lines:
        f = line.split("\t")
        start = int(f[1]) - 1
        end = start + len(f[3])
        for item in f[7].split(";"):
            if item.startswith("END="):
                end = int(item[4:])
        out.append((f[0], start, end, f[4] == "<*>"))
    return out


def check_gvcf(gvcf: str, vcf: str, ref: str, tag: str, card: str) -> dict:
    """The gVCF tiles every contig: its reference blocks and its variant
    records (each alt list extended by <*>) cover every A, C, G or T
    base of the reference once and no other base, in order, contig after
    contig; only variant records overlap, one another. Each block's REF is the reference base
    at its start (a block that a variant truncated takes its new first
    base from the FASTA). Every VCF record is in it, `<*>` appended. Its
    .tbi returns the records that overlap a region, END included."""
    from deepvariant_tpu_torch.core.types import Range
    from deepvariant_tpu_torch.io.fasta import FastaReader
    from deepvariant_tpu_torch.io.tabix import TabixReader, build_index

    fasta = FastaReader(ref)
    lines = vcf_records(gvcf)
    spans = gvcf_spans(lines)
    order = {c.name: i for i, c in enumerate(fasta.contigs)}
    keys = [(order[c], start) for c, start, _, _ in spans]
    if keys != sorted(keys):
        raise AssertionError(f"{tag}: the gVCF records are out of order")
    acgt = np.frombuffer(b"ACGT", np.uint8)
    overlapping = n_blocks = 0
    for contig in fasta.contigs:
        bases = fasta.bases(Range(contig.name, 0, contig.n_bases))
        covered = np.zeros(contig.n_bases, np.int32)
        by_blocks = np.zeros(contig.n_bases, np.int32)
        for (name, start, end, block), line in zip(spans, lines):
            if name != contig.name:
                continue
            covered[start:end] += 1
            if block:
                n_blocks += 1
                by_blocks[start:end] += 1
                if line.split("\t")[3] != chr(bases[start]):
                    raise AssertionError(
                        f"{tag}: the block at {name}:{start} has REF "
                        f"{line.split(chr(9))[3]}, the reference "
                        f"{chr(bases[start])}")
        dna = np.isin(bases, acgt)
        gaps = np.flatnonzero(dna & (covered == 0))
        beyond = np.flatnonzero(~dna & (covered > 0))
        twice = covered > 1
        if len(gaps) or len(beyond) or (by_blocks[twice] > 0).any():
            raise AssertionError(
                f"{tag}: the gVCF does not tile {contig.name}: "
                f"{len(gaps)} bases uncovered (first {gaps[:3]}), "
                f"{len(beyond)} non-ACGT bases covered, "
                f"{int((by_blocks[twice] > 0).sum())} bases under a block "
                "and another record")
        overlapping += int(twice.sum())
    in_gvcf = {tuple(line.split("\t")[:5]) for line in lines}
    vcf_lines = vcf_records(vcf)
    missing = [line for line in vcf_lines
               if tuple(line.split("\t")[:4])
               + (line.split("\t")[4] + ",<*>",) not in in_gvcf]
    if missing or not vcf_lines:
        raise AssertionError(f"{tag}: {len(missing)} of {len(vcf_lines)} VCF "
                             f"records are not in the gVCF ({missing[:2]})")
    if not os.path.exists(gvcf + ".tbi"):
        build_index(gvcf)
    # A region around a block in the middle: the index must return
    # exactly the records that overlap it, blocks by their END.
    name, pos, _, _ = [s for s in spans if s[3]][n_blocks // 2]
    lo, hi = max(0, pos - 300), pos + 300
    want = [line for line, (c, start, end, _) in zip(lines, spans)
            if c == name and start < hi and end > lo]
    got = list(TabixReader(gvcf).query(name, lo, hi))
    if got != want or not got:
        raise AssertionError(f"{tag}: the gVCF's .tbi returned {len(got)} "
                             f"records for {name}:{lo}-{hi}, the gVCF has "
                             f"{len(want)} there")
    print(f"[{tag}] {os.path.basename(gvcf)}: {len(lines)} records "
          f"({n_blocks} reference blocks) tile every A/C/G/T base of "
          f"{len(fasta.contigs)} contigs once, in order ({overlapping} bases "
          f"under two overlapping variant records); all {len(vcf_lines)} VCF "
          f"records "
          f"in it with <*>; its .tbi returns the {len(got)} records of "
          f"{name}:{lo}-{hi}; {card}")
    return {"gvcf_records": len(lines), "gvcf_blocks": n_blocks,
            "gvcf_variant_overlap_bases": overlapping,
            "gvcf_tbi_query_records": len(got)}


def time_cohort_parse(directory: str, tag: str, card: str) -> dict:
    """A population VCF of COHORT_PARSE_RECORDS seeded SNPs with an AF
    each, bgzipped, and the time of the first query of its reader, which
    parses the whole file, as each worker's first query does."""
    from deepvariant_tpu_torch.core.types import ContigInfo, Range, Variant
    from deepvariant_tpu_torch.io.vcf import VcfHeader, VcfWriter
    from deepvariant_tpu_torch.make_examples.allele_frequency import (
        make_population_vcf_readers,
    )

    rng = np.random.RandomState(SEED + 11)
    n = COHORT_PARSE_RECORDS
    starts = np.sort(rng.choice(n * 20, n, replace=False))
    refs = rng.randint(0, 4, n)
    alts = (refs + rng.randint(1, 4, n)) % 4
    afs = np.round(rng.uniform(0.0001, 0.5, n), 4)
    path = os.path.join(directory, "cohort.vcf.gz")
    header = VcfHeader([ContigInfo("chr1", n * 20, 0)], [], extras=[(
        "INFO", '<ID=AF,Number=A,Type=Float,Description="Allele '
        'frequency">')])
    with VcfWriter(path, header) as writer:
        for start, r, a, af in zip(starts.tolist(), refs.tolist(),
                                   alts.tolist(), afs.tolist()):
            writer.write(Variant(
                reference_name="chr1", start=start, end=start + 1,
                reference_bases="ACGT"[r], alternate_bases=["ACGT"[a]],
                info={"AF": [af]}))
    start = time.time()
    reader = make_population_vcf_readers([path])["chr1"]
    first = list(reader.query(Range("chr1", int(starts[n // 2]),
                                    int(starts[n // 2]) + 1)))
    seconds = time.time() - start
    if len(first) != 1:
        raise AssertionError(f"{tag}: the cohort query returned {first}")
    print(f"[{tag}] a population VCF of {n} records "
          f"({os.path.getsize(path)} bytes) parsed whole by its first "
          f"query in {seconds:.3f} s: {n / seconds:.1f} records/s; host CPUs "
          f"{os.cpu_count()}, beside {card}")
    return {"cohort_parse_records": n, "cohort_parse_s": seconds,
            "cohort_parse_records_per_s": n / seconds}


def phase_af_gvcf(tmp: str, model, device, card: str):
    """Phase 10: the WGS allele-frequency model from files to a VCF and a
    gVCF, by the stream and by the staged route, and the
    vcf_candidate_importer. Returns (numbers, the path's kernels-line
    entry with its launches)."""
    import torch

    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.core.genomics_math import round_gls
    from deepvariant_tpu_torch.core.types import CallVariantsOutput, Variant
    from deepvariant_tpu_torch.io.bgzf import BgzfReader
    from deepvariant_tpu_torch.io.fasta import FastaReader
    from deepvariant_tpu_torch.io.tfrecord import TFRecordReader, TFRecordWriter
    from deepvariant_tpu_torch.io.vcf import VcfReader
    from deepvariant_tpu_torch.make_examples import allele_frequency, core
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.presets import apply_model_preset
    from deepvariant_tpu_torch.make_examples.variant_caller import (
        VerySensitiveCaller,
    )
    from deepvariant_tpu_torch.scripts import postprocess_variants as cli
    from deepvariant_tpu_torch.testing import synthetic

    tag = "af-gvcf"
    kb = sum(n for _, n in AF_CONTIGS) / 1000
    directory = os.path.join(tmp, tag)
    sample = synthetic.synthetic_sample(
        SEED + 10, AF_CONTIGS, variant_spacing=REALIGN_VARIANT_SPACING)
    paths = write_sample_files(sample, directory, tag)
    vcfs = synthetic.write_vcf_inputs(sample, directory, seed=SEED + 10,
                                      population=True, proposed=True,
                                      exclude=True)

    def options(**more):
        o = apply_model_preset(MakeExamplesOptions(
            reads_filename=paths["reads"], ref_filename=paths["ref"],
            population_vcf_filenames=[vcfs["population"]],
            exclude_variants_vcf_filename=vcfs["exclude"], **more), "WGS")
        # --use_allele_frequency appends the channel to the preset's.
        o.pileup_options.channels = tuple(o.pileup_options.channels) + (
            CH_ALLELE_FREQUENCY,)
        return o

    pileup = options().pileup_options
    if not options().realigner_enabled:
        raise AssertionError("the WGS preset left the realigner off")
    af_plane = list(pileup.channels).index(CH_ALLELE_FREQUENCY)
    if (pileup.height, pileup.width, len(pileup.channels)) != AF_SHAPE:
        raise AssertionError(f"{tag}: the pileup is not {AF_SHAPE}")
    print(f"[{tag}] WGS preset with its defaults (realigner on) and the "
          f"allele_frequency channel: {pileup.height}x{pileup.width}x"
          f"{len(pileup.channels)}; a population VCF of "
          f"{len(list(VcfReader(vcfs['population'])))} records and an "
          f"exclude VCF of {len(list(VcfReader(vcfs['exclude'])))}")

    # Count what make_gvcfs, the exclude filter and the AF hook do during
    # the in-process run.
    tally = {"gvcf_s": 0.0, "gvcf_bases": 0, "blocks": 0, "filter_in": 0,
             "filter_out": 0, "af_s": 0.0, "af_candidates": 0}
    plain_make = VerySensitiveCaller.make_gvcfs
    plain_filters = core.RegionProcessor._apply_candidate_filters
    plain_af = allele_frequency.add_allele_frequencies_to_candidates

    def timed_make(self, counter, **kwargs):
        start = time.time()
        blocks = list(plain_make(self, counter, **kwargs))
        tally["gvcf_s"] += time.time() - start
        tally["gvcf_bases"] += len(counter.interval) - kwargs.get(
            "left_padding", 0) - kwargs.get("right_padding", 0)
        tally["blocks"] += len(blocks)
        return iter(blocks)

    def counted_filters(self, candidates, batch):
        kept = plain_filters(self, candidates, batch)
        tally["filter_in"] += len(candidates)
        tally["filter_out"] += len(kept)
        return kept

    def timed_af(candidates, reader, ref_reader):
        start = time.time()
        out = list(plain_af(candidates, reader, ref_reader))
        tally["af_s"] += time.time() - start
        tally["af_candidates"] += len(out)
        return iter(out)

    gvcf_records = os.path.join(directory, "gvcf.tfrecord.gz")
    VerySensitiveCaller.make_gvcfs = timed_make
    core.RegionProcessor._apply_candidate_filters = counted_filters
    allele_frequency.add_allele_frequencies_to_candidates = timed_af
    try:
        staged_options = options(gvcf_filename=gvcf_records)
        kept, runner = run_runner(staged_options, tmp, tag, card, 8)
    finally:
        VerySensitiveCaller.make_gvcfs = plain_make
        core.RegionProcessor._apply_candidate_filters = plain_filters
        allele_frequency.add_allele_frequencies_to_candidates = plain_af
    n_blocks = sum(1 for _ in TFRecordReader(gvcf_records))
    gvcf_s_per_kb = tally["gvcf_s"] / (tally["gvcf_bases"] / 1000)
    dropped = tally["filter_in"] - tally["filter_out"]
    print(f"[{tag}] make_gvcfs: {tally['blocks']} reference blocks over "
          f"{tally['gvcf_bases']} bases in {tally['gvcf_s']:.3f} s, "
          f"{gvcf_s_per_kb:.4f} s per kb in one worker; the exclude VCF "
          f"dropped {dropped} of {tally['filter_in']} candidates; the AF hook "
          f"matched {tally['af_candidates']} candidates in "
          f"{tally['af_s']:.3f} s; host CPUs {os.cpu_count()}, beside {card}")
    if n_blocks != tally["blocks"] or n_blocks == 0:
        raise AssertionError(f"{tag}: the gVCF TFRecord holds {n_blocks} "
                             f"records, make_gvcfs made {tally['blocks']}")
    # No excluded site among the candidates: a site of the exclude VCF
    # with an alt of the candidate at an AF at or above the threshold.
    threshold = staged_options.exclude_variants_af_threshold
    excluded = {}
    for rec in VcfReader(vcfs["exclude"]):
        for alt, af in zip(rec.alternate_bases, rec.info["AF"]):
            if af >= threshold:
                excluded.setdefault((rec.reference_name, rec.start,
                                     rec.reference_bases), set()).add(alt)
    candidates = [Variant.decode(buf) for buf in
                  TFRecordReader(staged_options.candidates_filename)]
    hits = [v for v in candidates if excluded.get(
        (v.reference_name, v.start, v.reference_bases), set())
        & set(v.alternate_bases)]
    if hits or dropped == 0:
        raise AssertionError(f"{tag}: {len(hits)} excluded sites among the "
                             f"candidates, {dropped} candidates dropped")
    af_rows = sum(int((p.plan["af"] != 0).sum()) for p in kept)
    print(f"[{tag}] no excluded site among the {len(candidates)} "
          f"candidates; {af_rows} rows of the kept plans carry a non-zero "
          "allele frequency")

    # The stream, then stage 3 with the workers' reference blocks.
    predictor = PlanPredictor(model, pileup, batch_size=BATCH, device=device)
    vcf = os.path.join(directory, "stream.vcf.gz")
    gvcf = os.path.join(directory, "stream.g.vcf.gz")
    stream, launches, ordered, cvos = run_stream(
        options(), kept, predictor, device, card, tag, vcf=vcf,
        ref=paths["ref"], sample_name=sample["sample_name"], gvcf=gvcf)
    with torch.inference_mode():
        af_pixels = int((predictor.encode(ordered[:BATCH])[..., af_plane]
                         != 0).sum())
    print(f"[{tag}] the allele-frequency plane of the first painted batch "
          f"has {af_pixels} non-zero pixels")
    if af_pixels == 0:
        raise AssertionError(f"{tag}: the allele-frequency plane is all zero")
    checked = check_vcf(vcf, cvos, paths["ref"], sample["sample_name"], tag,
                        card)

    # The staged route on the same plans: PlanPredictor in the stream's
    # batches (so the same probabilities), the CVOs to a TFRecord, the
    # postprocess CLI merging the runner's gVCF TFRecord.
    by_locus = {locus_key(p.variant, p.alt_indices): p for p in kept}
    planned = [by_locus[locus_key(c.variant, c.alt_allele_indices)]
               for c in cvos]
    probs = np.concatenate([predictor(ordered[i:i + BATCH])
                            for i in range(0, len(ordered), BATCH)])
    cvo_path = os.path.join(directory, "staged.cvo.tfrecord.gz")
    with TFRecordWriter(cvo_path) as writer:
        for p, prob in zip(planned, probs):
            writer.write(CallVariantsOutput(
                variant=Variant.decode(p.variant.encode()),
                alt_allele_indices=list(p.alt_indices),
                genotype_probabilities=round_gls(
                    [float(x) for x in prob])).encode())
    staged_vcf = os.path.join(directory, "staged.vcf.gz")
    staged_gvcf = os.path.join(directory, "staged.g.vcf.gz")
    buf = io.StringIO()
    start = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--ref", paths["ref"], "--infile", cvo_path,
                       "--outfile", staged_vcf,
                       "--nonvariant_site_tfrecord_path", gvcf_records,
                       "--gvcf_outfile", staged_gvcf])
    merge_s = time.time() - start
    print(f"[{tag}] postprocess_variants CLI with the gVCF merge: "
          f"{buf.getvalue().strip()} in {merge_s:.3f} s (both outputs "
          f"indexed); host CPUs {os.cpu_count()}, beside {card}")
    if rc != 0:
        raise AssertionError(f"{tag}: postprocess_variants CLI exited {rc}")
    for stream_path, staged_path in ((vcf, staged_vcf), (gvcf, staged_gvcf)):
        with BgzfReader(stream_path) as a, BgzfReader(staged_path) as b:
            if a.read_all() != b.read_all():
                raise AssertionError(
                    f"{tag}: {os.path.basename(stream_path)} differs from "
                    f"the staged route's {os.path.basename(staged_path)}")
    print(f"[{tag}] the stream's VCF and gVCF == the staged route's, byte "
          "for byte (decompressed)")
    tiled = check_gvcf(staged_gvcf, staged_vcf, paths["ref"], tag, card)
    if tiled["gvcf_records"] != stream["gvcf_records"]:
        raise AssertionError(f"{tag}: {tiled['gvcf_records']} gVCF records, "
                             f"stage 3 counted {stream['gvcf_records']}")

    # The importer: candidates only at proposed sites, regions without a
    # proposed variant skipped, its plans through PlanPredictor.
    importer_options = options(variant_caller="vcf_candidate_importer",
                               proposed_variants_filename=vcfs["proposed"])
    imported, importer = run_runner(importer_options, tmp, tag + "-importer",
                                    card, 4)
    proposed = {(v.reference_name, v.start, v.reference_bases,
                 tuple(v.alternate_bases))
                for v in VcfReader(vcfs["proposed"])}
    candidates = [Variant.decode(buf) for buf in
                  TFRecordReader(importer_options.candidates_filename)]
    strays = [v for v in candidates if (
        v.reference_name, v.start, v.reference_bases,
        tuple(v.alternate_bases)) not in proposed]
    if strays or not candidates:
        raise AssertionError(f"{tag}: {len(strays)} of {len(candidates)} "
                             "importer candidates are not proposed sites")
    with open(os.path.join(tmp, f"{tag}-importer.runtime_by_region.tsv")) as f:
        regions_run = sum(1 for _ in f) - 1
    regions_all = len(core.regions_to_process(
        FastaReader(paths["ref"]).contigs, importer_options.partition_size,
        None, None, None))
    imported_probs = np.concatenate([
        predictor([p.plan for p in imported[i:i + BATCH]])
        for i in range(0, len(imported), BATCH)])
    if imported_probs.shape != (len(imported), 3) or \
            not np.isfinite(imported_probs).all():
        raise AssertionError(f"{tag}: the importer's probabilities are "
                             "malformed")
    print(f"[{tag}] vcf_candidate_importer: {len(candidates)} candidates, "
          f"all proposed sites ({len(proposed)} proposed), {len(imported)} "
          f"plans classified on the card; {regions_run} of {regions_all} "
          "regions processed (the rest hold no proposed variant)")
    cohort = time_cohort_parse(directory, tag, card)

    to_gvcf_rate = stream["to_vcf_examples_per_s"]
    print(f"[{tag}] from the BAM to the VCF and the gVCF: "
          f"{to_gvcf_rate:.1f} examples/s ({stream['to_vcf_s']:.2f} s, stage "
          f"3 with the merge {stream['pipeline_postprocess_s']:.2f} s); "
          f"{card}; host CPUs {os.cpu_count()}")
    entry = from_files_entry("pileup_paint_plan_af_from_files", predictor,
                             ordered, tag, card)
    entry["launches"] = launches
    numbers = {f"af_{k}": v for part in (runner, stream, checked, tiled,
                                         cohort) for k, v in part.items()}
    numbers.update({
        "af_kb": kb, "af_make_gvcfs_s": tally["gvcf_s"],
        "af_make_gvcfs_s_per_kb": gvcf_s_per_kb,
        "af_gvcf_tfrecord_records": n_blocks,
        "af_excluded_candidates": dropped, "af_hook_s": tally["af_s"],
        "af_plane_pixels": af_pixels, "af_rows": af_rows,
        "af_merge_cli_s": merge_s, "af_to_gvcf_examples_per_s": to_gvcf_rate,
        "af_importer_candidates": len(candidates),
        "af_importer_plans": len(imported),
        "af_importer_regions": regions_run,
        "af_regions": regions_all})
    return numbers, entry


def run_deepvariant_cli(argv, tag: str, card: str):
    """`scripts/run_deepvariant.py` `main` in this process, which must
    exit 0; its output is printed under `tag`. Returns (output, wall
    seconds, the seconds of each stage as it reports them)."""
    from deepvariant_tpu_torch.scripts import run_deepvariant

    buf = io.StringIO()
    start = time.time()
    with contextlib.redirect_stdout(buf):
        rc = run_deepvariant.main(argv)
    seconds = time.time() - start
    text = buf.getvalue()
    for line in text.strip().splitlines():
        print(f"[{tag}] {line}")
    if rc != 0:
        raise AssertionError(f"{tag}: run_deepvariant exited {rc}")
    stages = {f"stage{m.group(1)}_s": float(m.group(2)) for m in re.finditer(
        r"stage (\d) \([^)]*\): ([0-9.]+)s", text)}
    print(f"[{tag}] run_deepvariant {seconds:.2f} s by the clock of this "
          f"process; {card}; host CPUs {os.cpu_count()}")
    return text, seconds, stages


def record_stream_cvos():
    """Wrap `stream_pipeline.stream_examples_to_cvos` so that the CVOs it
    hands to stage 3 are kept (copied first: stage 3 writes calls into
    them), with its StreamStats. Returns (the list that (cvos, stats)
    are appended to, a function that puts the plain one back)."""
    from deepvariant_tpu_torch.core.types import CallVariantsOutput
    from deepvariant_tpu_torch.parallel import stream_pipeline

    seen = []
    plain = stream_pipeline.stream_examples_to_cvos

    def recording(*args, **kwargs):
        result = plain(*args, **kwargs)
        seen.append(([CallVariantsOutput.decode(c.encode())
                      for c in result[0]], result[1]))
        return result

    stream_pipeline.stream_examples_to_cvos = recording

    def restore():
        stream_pipeline.stream_examples_to_cvos = plain

    return seen, restore


def example_records(spec: str) -> list:
    """The serialized examples of every shard of `spec`, in order."""
    from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
    from deepvariant_tpu_torch.io.tfrecord import TFRecordReader

    out = []
    for path in glob_sharded_inputs(spec):
        with TFRecordReader(path) as reader:
            out.extend(reader)
    return out


def examples_beside_plans(options, tag: str, card: str):
    """`make_examples_runner` in this process with an examples file (the
    host painter), and beside each example the plan of the same
    candidate, which the CUDA plan form paints. Returns (the serialized
    examples, the plans, the host painter's ms per example, the runner's
    seconds)."""
    from deepvariant_tpu_torch.make_examples.core import make_examples_runner
    from deepvariant_tpu_torch.make_examples.examples_builder import (
        ExamplesBuilder,
    )
    from deepvariant_tpu_torch.make_examples.pileup import PileupEncoder

    plans, painted = [], {"s": 0.0, "calls": 0}
    plain_build = ExamplesBuilder.build_examples_for_candidate
    plain_paint = PileupEncoder.build_pileup

    def with_plans(self, dv_call, batch, **kwargs):
        plans.extend(self.build_plans_for_candidate(dv_call, batch))
        yield from plain_build(self, dv_call, batch, **kwargs)

    def timed_paint(self, *args, **kwargs):
        start = time.perf_counter()
        image = plain_paint(self, *args, **kwargs)
        painted["s"] += time.perf_counter() - start
        painted["calls"] += 1
        return image

    ExamplesBuilder.build_examples_for_candidate = with_plans
    PileupEncoder.build_pileup = timed_paint
    try:
        start = time.time()
        counts = make_examples_runner(options)
        runner_s = time.time() - start
    finally:
        ExamplesBuilder.build_examples_for_candidate = plain_build
        PileupEncoder.build_pileup = plain_paint
    records = example_records(options.examples_filename)
    if counts["examples"] != len(records) or len(records) != len(plans) \
            or len(records) < 8:
        raise AssertionError(
            f"{tag}: {len(records)} examples, {len(plans)} plans, counts "
            f"{counts}; the phase needs at least 8 of each")
    paint_ms = 1000 * painted["s"] / len(records)
    print(f"[{tag}] the host painter (PileupEncoder.build_pileup, one row "
          f"at a time in numpy): {len(records)} examples in "
          f"{painted['s']:.3f} s, {paint_ms:.3f} ms per example; the "
          f"in-process shard (planning beside painting) {runner_s:.2f} s; "
          f"host CPUs {os.cpu_count()}, beside {card}")
    return records, plans, paint_ms, runner_s


def check_host_images(predictor, records, plans, tag: str) -> None:
    """Every host-painted image equals the CUDA plan form's image of the
    same candidate's plan, bit for bit."""
    import torch

    from deepvariant_tpu_torch.io import examples as example_codec

    mismatched = 0
    with torch.inference_mode():
        for i in range(0, len(plans), BATCH):
            chunk = plans[i:i + BATCH]
            images = predictor.encode([p.plan for p in chunk]).cpu().numpy()
            for k, planned in enumerate(chunk):
                ex = example_codec.parse_example(records[i + k])
                if locus_key(ex.variant, ex.alt_allele_indices) != \
                        locus_key(planned.variant, planned.alt_indices):
                    raise AssertionError(f"{tag}: example {i + k} and its "
                                         "plan are of other candidates")
                if not np.array_equal(ex.image, images[k]):
                    mismatched += 1
    print(f"[{tag}] {len(records)} host-painted images == the CUDA plan "
          f"form's images of the same candidates, bit for bit: "
          f"{mismatched == 0} ({mismatched} differ)")
    if mismatched:
        raise AssertionError(f"{tag}: {mismatched} host-painted images "
                             "differ from the CUDA plan form's")


def vcfs_agree(vcf, cvos, other_vcf, other_cvos, tag: str) -> int:
    """Two VCFs of the same candidates differ only at records where the
    CNN's bfloat16 moved a rounded probability of the record's CVO group
    between the two runs. Returns the number of records that differ."""
    moved = {}
    by_locus = {locus_key(c.variant, c.alt_allele_indices): c
                for c in other_cvos}
    for c in cvos:
        other = by_locus[locus_key(c.variant, c.alt_allele_indices)]
        if c.genotype_probabilities != other.genotype_probabilities:
            moved[(c.variant.reference_name, c.variant.start)] = True
    a, b = vcf_records(vcf), vcf_records(other_vcf)
    if len(a) != len(b):
        raise AssertionError(f"{tag}: {len(a)} and {len(b)} VCF records")
    differ = [(x, y) for x, y in zip(a, b) if x != y]
    stray = [x for x, _ in differ if (
        x.split("\t")[0], int(x.split("\t")[1]) - 1) not in moved]
    print(f"[{tag}] {len(differ)} of {len(a)} records differ, all where the "
          f"CNN's bfloat16 moved a rounded probability ({len(moved)} sites "
          "with a moved probability)")
    if stray:
        raise AssertionError(f"{tag}: {len(stray)} records differ where no "
                             f"probability moved: {stray[:2]}")
    return len(differ)


def phase_run_deepvariant(tmp: str, device, card: str):
    """Phase 11: the one-step command, `scripts/run_deepvariant.py`, from
    a BAM and a FASTA to a VCF and a gVCF, staged (2 shards) and
    streamed with each encoder; the host painter held bit-exact against
    the CUDA plan form. Returns (numbers, the kernels-line entry of the
    device-encode stream with its launches, the BAM route for phase
    13)."""
    from deepvariant_tpu_torch.calling.call_variants import read_cvos
    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.pileup import WGS_CHANNELS
    from deepvariant_tpu_torch.make_examples.presets import apply_model_preset
    from deepvariant_tpu_torch.models.checkpoint import save_variables
    from deepvariant_tpu_torch.ops import pileup_paint as pp
    from deepvariant_tpu_torch.testing import synthetic

    tag = "run-dv"
    directory = os.path.join(tmp, tag)
    sample = synthetic.synthetic_sample(
        SEED + 11, RUN_DV_CONTIGS, variant_spacing=REALIGN_VARIANT_SPACING)
    paths = write_sample_files(sample, directory, tag)
    model = seeded_model(SHAPE[2])
    checkpoint = os.path.join(directory, "ckpt")
    save_variables(os.path.join(checkpoint, "model.msgpack"), model,
                   {"shape": list(SHAPE), "channels": WGS_CHANNELS})
    host_model = seeded_model(RUN_DV_HOST_SHAPE[2])
    host_checkpoint = os.path.join(directory, "ckpt-host")
    save_variables(os.path.join(host_checkpoint, "model.msgpack"),
                   host_model, {"shape": list(RUN_DV_HOST_SHAPE)})

    # One shard in this process: the host painter's examples, and beside
    # them the plans of the same candidates, which the card paints.
    options = apply_model_preset(MakeExamplesOptions(
        reads_filename=paths["reads"], ref_filename=paths["ref"],
        examples_filename=os.path.join(directory, "in-process.tfrecord")),
        "WGS")
    if not options.realigner_enabled:
        raise AssertionError("the WGS preset left the realigner off")
    records, plans, paint_ms, _ = examples_beside_plans(options, tag, card)
    # The host painter's images against the CUDA plan form's on the same
    # candidates, bit for bit.
    predictor = PlanPredictor(model, options.pileup_options,
                              batch_size=BATCH, device=device)
    check_host_images(predictor, records, plans, tag)

    def argv(name, *more, ckpt=checkpoint):
        return ["--ref", paths["ref"], "--reads", paths["reads"],
                "--output_vcf", os.path.join(directory, f"{name}.vcf.gz"),
                "--output_gvcf", os.path.join(directory, f"{name}.g.vcf.gz"),
                "--checkpoint", ckpt, "--batch_size", str(BATCH),
                "--num_shards", str(STREAM_WORKERS),
                "--intermediate_results_dir", os.path.join(directory, name),
                *more]

    def outputs(name):
        return (os.path.join(directory, f"{name}.vcf.gz"),
                os.path.join(directory, f"{name}.g.vcf.gz"))

    # (a) Staged: make_examples in 2 spawned shards, call_variants on the
    # card, postprocess_variants with the gVCF.
    _, staged_s, stages = run_deepvariant_cli(argv("staged"), tag + " staged",
                                              card)
    staged_dir = os.path.join(directory, "staged")
    staged_records = example_records(os.path.join(
        staged_dir, f"make_examples.tfrecord@{STREAM_WORKERS}.gz"))
    if sorted(staged_records) != sorted(records):
        raise AssertionError(f"{tag}: the staged shards' {len(staged_records)}"
                             f" examples differ from the in-process shard's "
                             f"{len(records)}")
    staged_cvos = list(read_cvos(os.path.join(
        staged_dir, "call_variants_output.tfrecord.gz")))
    staged_vcf, staged_gvcf = outputs("staged")
    checked = check_vcf(staged_vcf, staged_cvos, paths["ref"], "default",
                        tag + " staged", card)
    tiled = check_gvcf(staged_gvcf, staged_vcf, paths["ref"],
                       tag + " staged", card)
    staged_rate = len(staged_records) / staged_s
    print(f"[{tag}] staged: the shards' examples == the in-process shard's; "
          f"{len(staged_cvos)} CVOs; from the BAM to the VCF and the gVCF "
          f"{staged_rate:.2f} examples/s; stage 1 per shard "
          f"{len(staged_records) / STREAM_WORKERS / stages['stage1_s']:.2f} "
          f"examples/s; {card}")

    # (b) Streamed, the plans painted on the card.
    seen, restore = record_stream_cvos()
    pp.paint_pileup.launches = 0
    try:
        text, stream_s, _ = run_deepvariant_cli(
            argv("stream", "--stream"), tag + " stream", card)
    finally:
        restore()
    launches = pp.paint_pileup.launches
    (stream_cvos, _), = seen
    batches = -(-len(stream_cvos) // BATCH)
    if "encoder=device" not in text or launches != batches or \
            len(stream_cvos) != len(staged_cvos):
        raise AssertionError(
            f"{tag}: the device-encode stream made {len(stream_cvos)} CVOs "
            f"with {launches} launches of the plan form for {batches} "
            "batches")
    stream_vcf, stream_gvcf = outputs("stream")
    check_vcf(stream_vcf, stream_cvos, paths["ref"], "default",
              tag + " stream", card)
    check_gvcf(stream_gvcf, stream_vcf, paths["ref"], tag + " stream", card)
    # The staged and streamed VCFs differ only where the CNN's bfloat16
    # moved a rounded probability of the record's CVO group.
    differ = vcfs_agree(staged_vcf, staged_cvos, stream_vcf, stream_cvos,
                        tag + " staged VCF vs streamed VCF")
    stream_rate = len(stream_cvos) / stream_s

    # (c) Streamed, a channel list the plan painter lacks: the workers
    # paint the pileups on the host, the card runs InceptionV3(9).
    seen, restore = record_stream_cvos()
    pp.paint_pileup.launches = 0
    try:
        text, host_s, _ = run_deepvariant_cli(
            argv("host", "--stream", "--channel_list", RUN_DV_HOST_CHANNELS,
                 ckpt=host_checkpoint), tag + " host-encode", card)
    finally:
        restore()
    (host_cvos, _), = seen
    if "encoder=host" not in text or pp.paint_pileup.launches != 0 or \
            len(host_cvos) != len(staged_cvos):
        raise AssertionError(
            f"{tag}: the host-encode stream made {len(host_cvos)} CVOs "
            f"({pp.paint_pileup.launches} launches of the plan form)")
    host_vcf, host_gvcf = outputs("host")
    check_vcf(host_vcf, host_cvos, paths["ref"], "default",
              tag + " host-encode", card)
    check_gvcf(host_gvcf, host_vcf, paths["ref"], tag + " host-encode",
               card)
    print(f"[{tag}] BAM to VCF and gVCF: staged {staged_rate:.2f}, streamed "
          f"(device encoder) {stream_rate:.2f}, streamed (host encoder, "
          f"100x221x9) {len(host_cvos) / host_s:.2f} examples/s; the plan "
          f"form launched {launches} times on the device-encode stream; "
          f"{card}; host CPUs {os.cpu_count()}")
    entry = from_files_entry("pileup_paint_plan_run_deepvariant_stream",
                             predictor, [p.plan for p in plans], tag, card)
    entry["launches"] = launches
    # What phase 13 holds the CRAM route against: the BAM route's sample,
    # files, in-process shard and staged outputs.
    bam_route = dict(sample=sample, paths=paths, model=model,
                     checkpoint=checkpoint, records=records, plans=plans,
                     staged_vcf=staged_vcf, staged_gvcf=staged_gvcf,
                     staged_cvos=staged_cvos)
    numbers = {f"run_dv_{k}": v for k, v in {
        **stages, **checked, **tiled,
        "examples": len(records), "host_paint_ms_per_example": paint_ms,
        "stage1_examples_per_s_per_shard":
            len(staged_records) / STREAM_WORKERS / stages["stage1_s"],
        "staged_s": staged_s, "staged_examples_per_s": staged_rate,
        "stream_s": stream_s, "stream_examples_per_s": stream_rate,
        "host_stream_s": host_s,
        "host_stream_examples_per_s": len(host_cvos) / host_s,
        "vcf_records_moved_by_bf16": differ,
        "plan_form_launches": launches}.items()}
    return numbers, entry, bam_route


def quiet(main, argv, tag: str) -> None:
    """A command line's `main` in this process, which must return 0; its
    standard output is printed under `tag`."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    for line in buf.getvalue().strip().splitlines():
        print(f"[{tag}] {line}")
    if rc != 0:
        raise AssertionError(f"{tag}: exited {rc}")


def wrap(owner, name: str, tally: dict, key: str, count=None):
    """Replace `owner.name` by a wrapper that adds its seconds to
    tally[key + "_s"], and `count(args, result)` to tally[key] when
    given; returns a function that puts the plain one back."""
    plain = getattr(owner, name)
    tally.setdefault(key + "_s", 0.0)
    tally.setdefault(key, 0)

    def wrapped(*args, **kwargs):
        start = time.perf_counter()
        result = plain(*args, **kwargs)
        tally[key + "_s"] += time.perf_counter() - start
        if count is not None:
            tally[key] += count(args, result)
        return result

    setattr(owner, name, wrapped)
    return lambda: setattr(owner, name, plain)


def format_fields(path: str) -> dict:
    """{(contig, pos, ref, alt): {MF, MD, MT, MI values}} of a VCF."""
    out = {}
    for line in vcf_records(path):
        cols = line.split("\t")
        fields = dict(zip(cols[8].split(":"), cols[9].split(":")))
        out[tuple(cols[:2] + cols[3:5])] = {
            k: v for k, v in fields.items() if k in ("MF", "MD", "MT", "MI")}
    return out


def phase_read_options(tmp: str, device, card: str):
    """Phase 12: the read-side options of make_examples. Route A (the
    kernel's route): WGS with its defaults, read normalization and the
    OQ tag; route B: PACBIO with the methylation channels, methylation
    calling and methylation-aware phasing (no paint kernel, as in the
    JAX package); route C: the three homopolymer-quality channels; and
    the candidate sweep. Returns (numbers, the kernels-line entry of
    route A's stream with its launches)."""
    from deepvariant_tpu_torch.calling.call_variants import read_cvos
    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.core.types import Range, Variant
    from deepvariant_tpu_torch.io import examples as example_codec
    from deepvariant_tpu_torch.io.bam import BamReader
    from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
    from deepvariant_tpu_torch.make_examples import core
    from deepvariant_tpu_torch.make_examples.pileup import WGS_CHANNELS
    from deepvariant_tpu_torch.make_examples.presets import apply_model_preset
    from deepvariant_tpu_torch.models.checkpoint import save_variables
    from deepvariant_tpu_torch.ops import pileup_paint as pp
    from deepvariant_tpu_torch.phasing import merge_phased_reads
    from deepvariant_tpu_torch.scripts import call_variants as cv_cli
    from deepvariant_tpu_torch.scripts import make_examples as me_cli
    from deepvariant_tpu_torch.scripts import postprocess_variants as pp_cli
    from deepvariant_tpu_torch.testing import synthetic

    cpus = os.cpu_count()
    phase_start = time.time()

    # -- route A: normalization and OQ, the plans painted by the kernel --
    tag = "read-options"
    directory = os.path.join(tmp, tag)
    sample = synthetic.add_read_options(
        synthetic.synthetic_sample(SEED + 11, RUN_DV_CONTIGS,
                                   variant_spacing=REALIGN_VARIANT_SPACING),
        SEED + 12, shifted_indels=READ_OPTIONS_SHIFTED_INDELS)
    paths = write_sample_files(sample, directory, tag)
    kb = sum(n for _, n in RUN_DV_CONTIGS) / 1000
    model = seeded_model(SHAPE[2])
    checkpoint = os.path.join(directory, "ckpt")
    save_variables(os.path.join(checkpoint, "model.msgpack"), model,
                   {"shape": list(SHAPE), "channels": WGS_CHANNELS})
    flags = ["--model_preset", "WGS", "--normalize_reads",
             "--use_original_quality_scores"]

    def options(*more):
        args = me_cli.build_parser().parse_args([
            "--mode", "calling", "--ref", paths["ref"], "--reads",
            paths["reads"], "--examples", "unused"] + flags + list(more))
        out = me_cli.resolved_options_from_args(args)
        if not (out.normalize_reads and out.use_original_quality_scores
                and out.realigner_enabled):
            raise AssertionError(f"{tag}: the flags did not reach the "
                                 "options")
        return out

    tally = {}
    restores = [
        wrap(core, "normalize_batch_cigars", tally, "normalized",
             lambda args, n: n),
        wrap(BamReader, "apply_original_quality_scores", tally, "oq_reads",
             lambda args, n: n)]
    try:
        in_process = options()
        in_process.examples_filename = os.path.join(directory,
                                                    "in-process.tfrecord")
        records, plans, paint_ms, runner_s = examples_beside_plans(
            in_process, tag, card)
    finally:
        for restore in restores:
            restore()
    print(f"[{tag}] read normalization rewrote {tally['normalized']} reads "
          f"in {tally['normalized_s']:.3f} s ({tally['normalized_s'] / kb:.5f}"
          f" s per kb); the OQ tag replaced the qualities of "
          f"{tally['oq_reads']} reads; host CPUs {cpus}, beside {card}")
    if tally["normalized"] == 0 or tally["oq_reads"] == 0:
        raise AssertionError(f"{tag}: normalization rewrote "
                             f"{tally['normalized']} reads, OQ replaced "
                             f"{tally['oq_reads']}")
    norm = tally
    predictor = PlanPredictor(model, in_process.pileup_options,
                              batch_size=BATCH, device=device)
    check_host_images(predictor, records, plans, tag)
    # The stream with the device encoder, to a VCF.
    vcf = os.path.join(directory, "stream.vcf.gz")
    stream, launches, ordered, stream_cvos = run_stream(
        options(), plans, predictor, device, card, tag + " stream", vcf=vcf,
        ref=paths["ref"], sample_name="default")
    check_vcf(vcf, stream_cvos, paths["ref"], "default", tag + " stream",
              card)
    # The make_examples CLI with the same flags, call_variants on the
    # card, postprocess_variants.
    examples = os.path.join(directory, "cli.tfrecord")
    start = time.time()
    quiet(me_cli.main, ["--mode", "calling", "--ref", paths["ref"],
                        "--reads", paths["reads"], "--examples", examples]
          + flags, tag + " make_examples")
    cli_records = example_records(examples)
    if sorted(cli_records) != sorted(records):
        raise AssertionError(f"{tag}: the CLI's {len(cli_records)} examples "
                             f"differ from the in-process shard's")
    cvo_path = os.path.join(directory, "cvo.tfrecord.gz")
    quiet(cv_cli.main, ["--examples", examples, "--outfile", cvo_path,
                        "--checkpoint", checkpoint, "--batch_size",
                        str(BATCH)], tag + " call_variants")
    staged_vcf = os.path.join(directory, "staged.vcf.gz")
    quiet(pp_cli.main, ["--ref", paths["ref"], "--infile", cvo_path,
                        "--outfile", staged_vcf], tag + " postprocess")
    staged_s = time.time() - start
    staged_cvos = list(read_cvos(cvo_path))
    check_vcf(staged_vcf, staged_cvos, paths["ref"],
              pp_cli._sample_name_from_cvos(cvo_path), tag + " staged", card)
    differ = vcfs_agree(staged_vcf, staged_cvos, vcf, stream_cvos,
                        tag + " staged VCF vs streamed VCF")
    print(f"[{tag}] the CLI's examples == the in-process shard's; staged "
          f"(make_examples, call_variants, postprocess_variants) "
          f"{staged_s:.2f} s; {card}")
    entry = from_files_entry("pileup_paint_plan_read_options", predictor,
                             ordered, tag, card)
    entry["launches"] = launches

    # -- route C: the homopolymer-quality channels, on reads with tp/t0 --
    ctag = "ultima"
    examples = os.path.join(directory, "ultima.tfrecord")
    ultima_model = seeded_model(ULTIMA_SHAPE[2])
    ultima_ckpt = os.path.join(directory, "ckpt-ultima")
    save_variables(os.path.join(ultima_ckpt, "model.msgpack"), ultima_model,
                   {"shape": list(ULTIMA_SHAPE)})
    tally = {}
    restore = wrap(BamReader, "parse_ultima_tags", tally, "tp_reads",
                   lambda args, n: n)
    try:
        quiet(me_cli.main, ["--mode", "calling", "--ref", paths["ref"],
                            "--reads", paths["reads"], "--examples",
                            examples, "--model_preset", "WGS",
                            "--no-realign_reads", "--channel_list",
                            ULTIMA_CHANNEL_LIST], ctag + " make_examples")
    finally:
        restore()
    shape = example_codec.read_example_info(examples)["shape"]
    images = np.stack([example_codec.parse_example(r).image
                       for r in example_records(examples)])
    flows = [len(np.unique(images[:, 5:, :, c])) for c in (7, 8, 9)]
    cvo_path = os.path.join(directory, "ultima.cvo.tfrecord.gz")
    quiet(cv_cli.main, ["--examples", examples, "--outfile", cvo_path,
                        "--checkpoint", ultima_ckpt, "--batch_size",
                        str(BATCH)], ctag + " call_variants")
    ultima_cvos = check_cvos(cvo_path, len(images))
    print(f"[{ctag}] {len(images)} examples of shape {tuple(shape)} from "
          f"{tally['tp_reads']} reads with a tp tag; distinct values in the "
          f"read rows of the homopolymer insertion, deletion and "
          f"inter-homopolymer planes: {flows}; {len(ultima_cvos)} CVOs from "
          f"call_variants on the card; {card}")
    if list(shape) != list(ULTIMA_SHAPE) or min(flows) < 3 or \
            tally["tp_reads"] == 0:
        raise AssertionError(f"{ctag}: shape {shape}, planes {flows}, "
                             f"{tally['tp_reads']} reads with tp")

    # -- the candidate sweep, on route A's sample --
    stag = "sweep"
    sweep_paths = []
    start = time.time()
    found = 0
    for task in range(STREAM_WORKERS):
        sweep = options()
        sweep.mode = "candidate_sweep"
        sweep.task_id, sweep.num_shards = task, STREAM_WORKERS
        sweep_paths.append(os.path.join(directory, f"sweep-{task}.pos"))
        found += core.candidate_sweep_runner(sweep, sweep_paths[-1])
    sweep_s = time.time() - start
    merged = core.load_candidate_positions(sweep_paths)
    positions = merged[merged >= 0]
    regions = [Range(name, 0, n) for name, n in RUN_DV_CONTIGS]
    partitions = core.partition_by_candidates(regions, merged,
                                              SWEEP_PARTITION_CANDIDATES)
    print(f"[{stag}] --mode candidate_sweep in {STREAM_WORKERS} shards: "
          f"{len(positions)} candidate positions in {sweep_s:.2f} s, merged "
          f"into {len(partitions)} partitions of at most "
          f"{SWEEP_PARTITION_CANDIDATES} candidates; host CPUs {cpus}")
    if len(positions) != found or found == 0 or \
            int((merged == core.END_OF_REGION).sum()) != len(regions) or \
            len(partitions) <= len(regions):
        raise AssertionError(f"{stag}: {len(positions)} merged positions of "
                             f"{found}, {len(partitions)} partitions")

    # -- route B: methylation, PACBIO at full width --
    mtag = "methylation"
    mdir = os.path.join(tmp, mtag)
    start = time.time()
    msample = synthetic.add_methylation(synthetic.synthetic_longread_sample(
        SEED + 13, METH_CONTIGS, depth=METH_DEPTH,
        mean_read_length=METH_READ_LENGTH, variant_spacing=METH_SPACING,
        cpg_snps=True), SEED + 14)
    print(f"[{mtag}] made the methylated long-read sample in "
          f"{time.time() - start:.1f} s")
    mpaths = write_sample_files(msample, mdir, mtag)
    mkb = sum(n for _, n in METH_CONTIGS) / 1000
    meth_model = seeded_model(METH_SHAPE[2])
    meth_ckpt = os.path.join(mdir, "ckpt")
    save_variables(os.path.join(meth_ckpt, "model.msgpack"), meth_model,
                   {"shape": list(METH_SHAPE)})
    meth_flags = ["--model_preset", "PACBIO", "--channel_list",
                  METH_CHANNEL_LIST, "--enable_methylation_calling",
                  "--enable_methylation_aware_phasing"]
    # One shard in this process, timed stage by stage.
    args = me_cli.build_parser().parse_args([
        "--mode", "calling", "--ref", mpaths["ref"], "--reads",
        mpaths["reads"], "--examples", os.path.join(mdir, "in-process.tfrecord"),
        "--candidates", os.path.join(mdir, "candidates.tfrecord")]
        + meth_flags)
    moptions = me_cli.resolved_options_from_args(args)
    tally = {}

    def assigned(args, phases):
        return sum(p != 0 and q == 0 for p, q in zip(phases, args[4]))

    restores = [
        wrap(BamReader, "parse_methylation", tally, "meth_reads",
             lambda args, n: len(args[1])),
        wrap(core.RegionProcessor, "_phase_by_methylation", tally,
             "meth_phased", assigned),
        wrap(core.RegionProcessor, "_add_methylation_stats", tally,
             "mf_md", lambda args, result: len(args[2])),
        wrap(core.RegionProcessor, "_methylated_ref_site_candidates", tally,
             "ref_sites", lambda args, sites: len(sites))]
    pp.paint_pileup.launches = 0
    try:
        start = time.time()
        counts = core.make_examples_runner(moptions)
        mrunner_s = time.time() - start
    finally:
        for restore in restores:
            restore()
    candidates = [Variant.decode(b) for b in TFRecordReader(
        moptions.candidates_filename)]
    with_mf = sum(any(f > 0 for f in v.calls[0].info.get("MF", []))
                  for v in candidates if v.alternate_bases != ["."])
    print(f"[{mtag}] one shard in process, {counts['examples']} examples "
          f"({mkb:.0f} kb) in {mrunner_s:.2f} s: MM/ML parsing "
          f"{tally['meth_reads']} reads in {tally['meth_reads_s']:.3f} s "
          f"({tally['meth_reads'] / tally['meth_reads_s']:.1f} reads/s); "
          f"methylation-aware phasing assigned {tally['meth_phased']} reads "
          f"in {tally['meth_phased_s']:.3f} s "
          f"({tally['meth_phased_s'] / mkb:.5f} s per kb); MF/MD on "
          f"{tally['mf_md']} candidates in {tally['mf_md_s']:.3f} s "
          f"({tally['mf_md_s'] / mkb:.5f} s per kb), {with_mf} with MF > 0; "
          f"{tally['ref_sites']} '.'-alt methylated reference sites in "
          f"{tally['ref_sites_s']:.3f} s; host CPUs {cpus}, beside {card}")
    if tally["meth_phased"] == 0 or with_mf == 0 or tally["ref_sites"] == 0:
        raise AssertionError(f"{mtag}: {tally}, {with_mf} candidates with MF")

    def margv(name, *more):
        return ["--model_type", "PACBIO", "--ref", mpaths["ref"],
                "--reads", mpaths["reads"],
                "--output_vcf", os.path.join(mdir, f"{name}.vcf.gz"),
                "--checkpoint", meth_ckpt, "--batch_size", str(BATCH),
                "--num_shards", str(STREAM_WORKERS),
                "--channel_list", METH_CHANNEL_LIST,
                "--enable_methylation_calling",
                "--enable_methylation_aware_phasing",
                "--intermediate_results_dir", os.path.join(mdir, name),
                *more]

    phase_spec = os.path.join(mdir, f"phase@{STREAM_WORKERS}.tsv")
    _, mstaged_s, stages = run_deepvariant_cli(margv(
        "staged", "--make_examples_extra_args",
        f"output_local_read_phasing={phase_spec},output_phase_info=true"),
        mtag + " staged", card)
    staged_cvos = list(read_cvos(os.path.join(
        mdir, "staged", "call_variants_output.tfrecord.gz")))
    staged_vcf = os.path.join(mdir, "staged.vcf.gz")
    check_vcf(staged_vcf, staged_cvos, mpaths["ref"], "default",
              mtag + " staged", card)
    fields = format_fields(staged_vcf)
    n_mf = sum({"MF", "MD", "MT"} <= set(f) for f in fields.values())
    n_mi = sum("MI" in f for f in fields.values())
    # merge_phased_reads on the shards' read phases, then stage 3 with
    # the switches TSV.
    switches = os.path.join(mdir, "switches.tsv")
    quiet(merge_phased_reads.main, [
        "--input_path", phase_spec,
        "--output_path", os.path.join(mdir, "merged.tsv"),
        "--switches_output_path", switches], mtag + " merge_phased_reads")
    with open(switches) as f:
        n_switches = len(f.read().splitlines())
    switched_vcf = os.path.join(mdir, "switched.vcf.gz")
    quiet(pp_cli.main, ["--ref", mpaths["ref"], "--infile", os.path.join(
        mdir, "staged", "call_variants_output.tfrecord.gz"),
        "--outfile", switched_vcf, "--phased_reads_switches_output_path",
        switches], mtag + " postprocess with switches")
    if format_fields(switched_vcf) != fields:
        raise AssertionError(f"{mtag}: the VCF with the switches TSV has "
                             "other methylation fields")
    # --stream: the methylation channels are the host painter's.
    seen, restore = record_stream_cvos()
    try:
        text, mstream_s, _ = run_deepvariant_cli(margv(
            "stream", "--stream", "--make_examples_extra_args",
            "output_phase_info=true"), mtag + " stream", card)
    finally:
        restore()
    (mstream_cvos, _), = seen
    stream_vcf = os.path.join(mdir, "stream.vcf.gz")
    check_vcf(stream_vcf, mstream_cvos, mpaths["ref"], "default",
              mtag + " stream", card)
    meth_launches = pp.paint_pileup.launches
    same = format_fields(stream_vcf) == fields
    print(f"[{mtag}] staged VCF: {len(fields)} records, {n_mf} with MF, MD "
          f"and MT, {n_mi} with MI; {n_switches} (shard, region) groups in "
          f"the switches TSV; the streamed VCF's MF/MD/MT/MI == the staged "
          f"VCF's: {same}; paint kernel launches on this route: "
          f"{meth_launches} (the methylation channels are painted on the "
          f"host, as in the JAX package); BAM to VCF staged "
          f"{len(staged_cvos) / mstaged_s:.2f}, streamed (host encoder, "
          f"100x147x12) {len(mstream_cvos) / mstream_s:.2f} examples/s; "
          f"{card}; host CPUs {cpus}")
    if "encoder=host" not in text or not same or n_mf == 0 or n_mi == 0 \
            or meth_launches != 0 or n_switches == 0:
        raise AssertionError(f"{mtag}: {n_mf} records with MF/MD/MT, {n_mi} "
                             f"with MI, {meth_launches} launches, streamed "
                             f"fields equal: {same}")
    numbers = {
        "read_options_examples": len(records),
        "read_options_host_paint_ms_per_example": paint_ms,
        "read_options_one_worker_s": runner_s,
        "read_options_normalized_reads": norm["normalized"],
        "read_options_normalize_s_per_kb": norm["normalized_s"] / kb,
        "read_options_oq_reads": norm["oq_reads"],
        "read_options_stream_to_vcf_s": stream.get("to_vcf_s"),
        "read_options_staged_s": staged_s,
        "read_options_vcf_records_moved_by_bf16": differ,
        "read_options_plan_form_launches": launches,
        "ultima_examples": len(images),
        "sweep_positions": int(len(positions)),
        "sweep_partitions": len(partitions), "sweep_s": sweep_s,
        "methylation_examples": counts["examples"],
        "methylation_one_worker_s": mrunner_s,
        "methylation_kb": mkb,
        "methylation_parse_reads_per_s":
            tally["meth_reads"] / tally["meth_reads_s"],
        "methylation_phasing_s_per_kb": tally["meth_phased_s"] / mkb,
        "methylation_reads_assigned": tally["meth_phased"],
        "methylation_mf_md_s_per_kb": tally["mf_md_s"] / mkb,
        "methylation_vcf_records_mf_md_mt": n_mf,
        "methylation_vcf_records_mi": n_mi,
        "methylation_staged_s": mstaged_s, "methylation_stream_s": mstream_s,
        "methylation_paint_launches": meth_launches,
        "phase12_s": time.time() - phase_start}
    print(f"[{tag}] phase 12 (routes A, C, B and the sweep) "
          f"{numbers['phase12_s']:.1f} s; {card}")
    return numbers, entry


def phase_cram_training(tmp: str, device, card: str, bam_route: dict):
    """Phase 13: CRAM input and training mode. Route A: phase 11's
    sample written as a CRAM (rANS order 1, the FASTA as reference, a
    .crai) and run as phase 11 ran its BAM: the in-process shard's plans
    and examples equal the BAM's, every host-painted image equals the
    CUDA plan form's, then `run_deepvariant --reads x.cram` staged and
    `--stream` (device encoder) to a VCF and a gVCF, apart from the BAM
    route's only where bfloat16 moved a rounded probability. Route B: the
    make_examples CLI in training mode on the CRAM and on the BAM (truth
    VCF, confident regions, the haplotype labeler) writes the same
    examples; the runner's labeled plans of the same options are painted
    by the CUDA plan form, equal to the labeled examples image by image
    and label by label; labeled_examples_to_vcf writes their VCF.
    Returns (numbers, the kernels-line entries of route A's stream and of
    route B's labeled plans, with their launches, and the paths of route
    B's labeled examples from the CRAM and from the BAM)."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import read_cvos
    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.io import examples as example_codec
    from deepvariant_tpu_torch.io.cram import CramBatchReader
    from deepvariant_tpu_torch.labeler import labeled_examples_to_vcf
    from deepvariant_tpu_torch.labeler.haplotype_labeler import (
        HaplotypeLabeler,
    )
    from deepvariant_tpu_torch.make_examples.core import (
        MakeExamplesOptions,
        make_examples_runner,
    )
    from deepvariant_tpu_torch.make_examples.presets import apply_model_preset
    from deepvariant_tpu_torch.ops import pileup_paint as pp
    from deepvariant_tpu_torch.scripts import make_examples as me_cli
    from deepvariant_tpu_torch.testing import cram_writer, synthetic

    cpus = os.cpu_count()
    phase_start = time.time()
    tag = "cram"
    directory = os.path.join(tmp, tag)
    os.makedirs(directory)
    sample, paths = bam_route["sample"], bam_route["paths"]
    kb = sum(n for _, n in sample["contigs"]) / 1000
    n_records = len(sample["reads"]["name"])
    start = time.time()
    cram = cram_writer.write_cram(sample, os.path.join(directory,
                                                       "reads.cram"))
    print(f"[{tag}] wrote {n_records} reads as CRAM 3.0 (rANS order 1, the "
          f"FASTA as reference, .crai) in {time.time() - start:.1f} s: "
          f"{os.path.getsize(cram)} bytes, the BAM "
          f"{os.path.getsize(paths['reads'])}")

    # -- route A: the CRAM through run_deepvariant, the plans on the card --
    # The CRAM decode, timed where a worker pays it: the whole file at
    # its first query (the later calls return the decoded reads).
    decode = {}
    restore = wrap(CramBatchReader, "_all_reads", decode, "decode")
    try:
        in_process = apply_model_preset(MakeExamplesOptions(
            reads_filename=cram, ref_filename=paths["ref"],
            examples_filename=os.path.join(directory, "in-process.tfrecord")),
            "WGS")
        records, plans, paint_ms, runner_s = examples_beside_plans(
            in_process, tag, card)
    finally:
        restore()
    decode_rate = n_records / decode["decode_s"]
    decode_share = decode["decode_s"] / runner_s
    print(f"[{tag}] CRAM decode: {n_records} records in "
          f"{decode['decode_s']:.3f} s, {decode_rate:.1f} reads/s, "
          f"{decode_share:.1%} of the in-process shard's {runner_s:.2f} s; "
          f"host CPUs {cpus}, beside {card}")
    same_plans = plans_equal(plans, bam_route["plans"])
    same_examples = records == bam_route["records"]
    print(f"[{tag}] the in-process shard from the CRAM: {len(plans)} plans "
          f"== the BAM's, bit for bit: {same_plans}; {len(records)} "
          f"examples == the BAM's, byte for byte: {same_examples}")
    if not (same_plans and same_examples):
        raise AssertionError(f"{tag}: the CRAM's plans or examples differ "
                             "from the BAM's")
    model, checkpoint = bam_route["model"], bam_route["checkpoint"]
    predictor = PlanPredictor(model, in_process.pileup_options,
                              batch_size=BATCH, device=device)
    check_host_images(predictor, records, plans, tag)

    def argv(name, *more):
        return ["--ref", paths["ref"], "--reads", cram,
                "--output_vcf", os.path.join(directory, f"{name}.vcf.gz"),
                "--output_gvcf", os.path.join(directory, f"{name}.g.vcf.gz"),
                "--checkpoint", checkpoint, "--batch_size", str(BATCH),
                "--num_shards", str(STREAM_WORKERS),
                "--intermediate_results_dir", os.path.join(directory, name),
                *more]

    def outputs(name):
        return (os.path.join(directory, f"{name}.vcf.gz"),
                os.path.join(directory, f"{name}.g.vcf.gz"))

    # Staged: make_examples in 2 spawned shards on the CRAM.
    _, staged_s, stages = run_deepvariant_cli(argv("staged"),
                                              tag + " staged", card)
    staged_dir = os.path.join(directory, "staged")
    staged_records = example_records(os.path.join(
        staged_dir, f"make_examples.tfrecord@{STREAM_WORKERS}.gz"))
    if sorted(staged_records) != sorted(records):
        raise AssertionError(f"{tag}: the staged shards' examples differ "
                             "from the in-process shard's")
    staged_cvos = list(read_cvos(os.path.join(
        staged_dir, "call_variants_output.tfrecord.gz")))
    staged_vcf, staged_gvcf = outputs("staged")
    check_vcf(staged_vcf, staged_cvos, paths["ref"], "default",
              tag + " staged", card)
    check_gvcf(staged_gvcf, staged_vcf, paths["ref"], tag + " staged", card)
    # The CRAM route against phase 11's BAM route.
    moved_vcf = vcfs_agree(staged_vcf, staged_cvos, bam_route["staged_vcf"],
                           bam_route["staged_cvos"],
                           tag + " staged VCF vs the BAM's")
    moved_gvcf = vcfs_agree(staged_gvcf, staged_cvos,
                            bam_route["staged_gvcf"],
                            bam_route["staged_cvos"],
                            tag + " staged gVCF vs the BAM's")
    # Streamed, the plans painted on the card.
    seen, restore = record_stream_cvos()
    pp.paint_pileup.launches = 0
    try:
        text, stream_s, _ = run_deepvariant_cli(
            argv("stream", "--stream"), tag + " stream", card)
    finally:
        restore()
    launches = pp.paint_pileup.launches
    (stream_cvos, _), = seen
    batches = -(-len(stream_cvos) // BATCH)
    if "encoder=device" not in text or launches != batches or \
            not launches or len(stream_cvos) != len(staged_cvos):
        raise AssertionError(
            f"{tag}: the device-encode stream made {len(stream_cvos)} CVOs "
            f"with {launches} launches of the plan form for {batches} "
            "batches")
    stream_vcf, stream_gvcf = outputs("stream")
    check_vcf(stream_vcf, stream_cvos, paths["ref"], "default",
              tag + " stream", card)
    check_gvcf(stream_gvcf, stream_vcf, paths["ref"], tag + " stream", card)
    moved_stream = vcfs_agree(stream_vcf, stream_cvos, staged_vcf,
                              staged_cvos, tag + " streamed VCF vs staged")
    print(f"[{tag}] CRAM to VCF and gVCF: staged {len(staged_cvos) / staged_s:.2f}"
          f", streamed (device encoder) {len(stream_cvos) / stream_s:.2f} "
          f"examples/s; records apart from the BAM route's: VCF {moved_vcf},"
          f" gVCF {moved_gvcf} (where bfloat16 moved a rounded GL); the plan"
          f" form launched {launches} times on the stream; {card}; host CPUs"
          f" {cpus}")
    entry_a = from_files_entry("pileup_paint_plan_cram_stream", predictor,
                               [p.plan for p in plans], tag, card)
    entry_a["launches"] = launches

    # -- route B: training mode on the CRAM, the labeled plans on the card --
    btag = "training"
    truth = synthetic.write_truth_inputs(sample, directory, seed=SEED + 13)
    flags = ["--mode", "training", "--ref", paths["ref"], "--model_preset",
             "WGS", "--truth_variants", truth["truth"],
             "--confident_regions", truth["confident"]]
    labeling = {"s": 0.0, "calls": 0}
    plain_label = HaplotypeLabeler.label_variants

    def timed_label(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = list(plain_label(self, *args, **kwargs))
        labeling["s"] += time.perf_counter() - t0
        labeling["calls"] += 1
        return out

    examples = {}
    HaplotypeLabeler.label_variants = timed_label
    try:
        for name, reads in (("cram", cram), ("bam", paths["reads"])):
            examples[name] = os.path.join(directory, f"train-{name}.tfrecord")
            start = time.time()
            quiet(me_cli.main, flags + ["--reads", reads, "--examples",
                                        examples[name]],
                  f"{btag} make_examples {name}")
            if name == "cram":
                cli_s = time.time() - start
                label_s = labeling["s"]
    finally:
        HaplotypeLabeler.label_variants = plain_label
    blobs = {}
    for name, path in examples.items():
        with open(path, "rb") as f, \
                open(path + ".labeling_metrics.json") as g:
            blobs[name] = (f.read(), g.read())
    metrics = json.loads(blobs["cram"][1])
    if blobs["cram"] != blobs["bam"]:
        raise AssertionError(f"{btag}: the CLI's labeled examples from the "
                             "CRAM differ from the BAM's")
    labeled_records = example_records(examples["cram"])
    # The runner with a plan sink on the same options: the labeled plans.
    args = me_cli.build_parser().parse_args(flags + [
        "--reads", cram, "--examples", "unused"])
    options = me_cli.resolved_options_from_args(args)
    options.examples_filename = ""
    labeled = []
    make_examples_runner(options, plan_sink=labeled.append)
    if len(labeled) != len(labeled_records) or len(labeled) < 8:
        raise AssertionError(f"{btag}: {len(labeled)} labeled plans, "
                             f"{len(labeled_records)} labeled examples")
    train_predictor = PlanPredictor(model, options.pileup_options,
                                    batch_size=BATCH, device=device)
    # The path: the labeled plans painted on the card, batch by batch.
    pp.paint_pileup.launches = 0
    images = []
    with torch.inference_mode():
        for i in range(0, len(labeled), BATCH):
            images.append(train_predictor.encode(
                [p.plan for p in labeled[i:i + BATCH]]).cpu().numpy())
    train_launches = pp.paint_pileup.launches
    images = np.concatenate(images)
    differ = 0
    labels = []
    for k, (planned, buf) in enumerate(zip(labeled, labeled_records)):
        ex = example_codec.parse_example(buf)
        if locus_key(ex.variant, ex.alt_allele_indices) != \
                locus_key(planned.variant, planned.alt_indices) or \
                ex.label != planned.label or ex.label is None:
            raise AssertionError(f"{btag}: example {k} and its plan differ "
                                 "in locus or label")
        differ += not np.array_equal(ex.image, images[k])
        labels.append(ex.label)
    print(f"[{btag}] {len(labeled)} labeled plans painted by the CUDA plan "
          f"form in {train_launches} launches; images == the labeled "
          f"examples' bit for bit: {differ == 0} ({differ} differ); labels "
          f"equal; labels 0/1/2: {labels.count(0)}/{labels.count(1)}/"
          f"{labels.count(2)}")
    if differ or train_launches != -(-len(labeled) // BATCH):
        raise AssertionError(f"{btag}: {differ} images differ, "
                             f"{train_launches} launches")
    entry_b = from_files_entry("pileup_paint_plan_training_labeled",
                               train_predictor, [p.plan for p in labeled],
                               btag, card)
    entry_b["launches"] = train_launches
    # The labeled examples as a VCF.
    vcf = os.path.join(directory, "labeled.vcf.gz")
    with contextlib.redirect_stderr(io.StringIO()):
        rc = labeled_examples_to_vcf.main([
            "--examples", examples["cram"], "--ref", paths["ref"],
            "--output_vcf", vcf])
    records_vcf = vcf_records(vcf)
    gts = {line.split("\t")[9].split(":")[0] for line in records_vcf}
    if rc != 0 or not records_vcf or not gts & {"0/1", "1/1", "1/2"}:
        raise AssertionError(f"{btag}: labeled_examples_to_vcf exited {rc} "
                             f"with {len(records_vcf)} records, GTs {gts}")
    tp, fp, fn = (metrics[f"n_{k}_sites"] for k in (
        "true_positive", "false_positive", "false_negative"))
    print(f"[{btag}] labeling metrics: TP {tp}, FP {fp}, FN {fn} sites; the "
          f"haplotype labeler {label_s:.3f} s ({label_s / kb:.5f} s per kb, "
          f"{label_s / cli_s:.1%} of the CLI's {cli_s:.2f} s); "
          f"labeled_examples_to_vcf: {len(records_vcf)} records, GTs "
          f"{sorted(gts)}; the CLI's examples from the CRAM == the BAM's, "
          f"byte for byte; host CPUs {cpus}, beside {card}")
    if min(tp, fp, fn) <= 0:
        raise AssertionError(f"{btag}: TP {tp}, FP {fp}, FN {fn}")
    numbers = {
        "cram_records": n_records,
        "cram_decode_reads_per_s": decode_rate,
        "cram_decode_share_of_shard": decode_share,
        "cram_examples": len(records),
        "cram_staged_s": staged_s, "cram_stream_s": stream_s,
        "cram_stage1_s": stages.get("stage1_s"),
        "cram_vcf_records_apart_from_bam": moved_vcf,
        "cram_gvcf_records_apart_from_bam": moved_gvcf,
        "cram_stream_vcf_records_moved_by_bf16": moved_stream,
        "cram_plan_form_launches": launches,
        "training_examples": len(labeled),
        "training_tp_sites": tp, "training_fp_sites": fp,
        "training_fn_sites": fn,
        "training_labeler_s_per_kb": label_s / kb,
        "training_plan_form_launches": train_launches,
        "training_labeled_vcf_records": len(records_vcf),
        "phase13_s": time.time() - phase_start}
    print(f"[{tag}] phase 13 (routes A and B) {numbers['phase13_s']:.1f} s; "
          f"{card}")
    # Route B's labeled examples, from the CRAM and from the BAM (equal
    # byte for byte), for phase 14 to train on.
    labeled_examples = {"train": examples["cram"], "tune": examples["bam"]}
    return numbers, [entry_a, entry_b], labeled_examples



def read_flax(path: str) -> dict:
    from deepvariant_tpu_torch.io import flax_msgpack

    with open(path, "rb") as f:
        return flax_msgpack.unpack(f.read())


def flat_tree(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(flat_tree(value, prefix + (key,)))
        return out
    return {prefix: np.asarray(tree)}


def forward_flops_per_example(shape) -> float:
    """2 x multiply-adds of every conv and of the head of InceptionV3 for
    one (H, W, C) example, counted from the output shapes of a forward
    pass on the meta device (no data, no card)."""
    import torch

    from deepvariant_tpu_torch.models.inception_v3 import ConvBN, InceptionV3

    model = InceptionV3(shape[2]).to("meta").eval()
    total = []

    def conv_hook(module, inputs, output):
        conv = module.conv
        kh, kw = conv.kernel_size
        total.append(2 * output.numel() * conv.in_channels * kh * kw)

    def head_hook(module, inputs, output):
        total.append(2 * output.numel() * module.in_features)

    for module in model.modules():
        if isinstance(module, ConvBN):
            module.register_forward_hook(conv_hook)
    model.classification.register_forward_hook(head_hook)
    with torch.no_grad():
        model(torch.zeros((1,) + tuple(shape), device="meta"))
    return float(sum(total))


def update_distance(got: dict, want: dict, start: dict, group) -> float:
    """Relative L2 distance between two states' moves from `start` (the
    initial weights for params and ema_params, zero for an optimizer
    tree) over the leaves under `group`."""
    keys = [k for k in want if k[:len(group)] == group]
    if not keys or set(keys) != {k for k in got if k[:len(group)] == group}:
        raise AssertionError(f"state trees differ under {group}")

    def origin(k):
        return start[("params",) + k[1:]] if group[0] in (
            "params", "ema_params") else 0

    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in keys)
    den = sum(float(np.sum((want[k].astype(np.float64) - origin(k)) ** 2))
              for k in keys)
    return (num / den) ** 0.5


def one_train_step(weights: dict, batch: dict, optimizer: str, device,
                   dtype, compute=None):
    """The port's state (flax layout, numpy) and loss after one train
    step of InceptionV3(7), dropout 0, from `weights` on `device`: the
    weights in `dtype` (the head in float32, as the pooled features
    are), computing in `compute` (default `dtype`)."""
    import torch

    from deepvariant_tpu_torch.models.checkpoint import state_to_flax
    from deepvariant_tpu_torch.models.inception_v3 import InceptionV3
    from deepvariant_tpu_torch.training import train as train_lib
    from deepvariant_tpu_torch.training.config import TrainConfig

    cfg = TrainConfig(optimizer=optimizer, use_mixed_precision=False,
                      learning_rate=0.01 if optimizer == "sgd" else 1e-3)
    model = InceptionV3(SHAPE[2], dropout_rate=0.0, dtype=compute or dtype)
    tx, _ = train_lib.make_optimizer(cfg, 10)
    variables = {c: {k: v.to(device, torch.float32 if k.startswith(
        "classification") else dtype) for k, v in tree.items()}
        for c, tree in weights.items()}
    state = train_lib.init_state(model, variables, tx)
    start = state_to_flax(state)
    state, loss, _ = train_lib.make_train_step(model, tx, cfg)(
        state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    return start, state_to_flax(state), float(loss)


def time_train_steps(data: dict, dtype_name: str, accum: int, device,
                     card: str, flops_per_example: float,
                     steps: int, warmup: int) -> dict:
    """ms per train step of the full InceptionV3(7) at batch
    TRAIN_BATCH x `accum` (forward, backward and update, back to back;
    CUDA events), each step's batch gathered on the card from the
    resident examples as train_resident gathers it. The batch norm + ReLU
    kernels must launch 4 times a layer, 94 layers, and the pool kernels
    13 times forward and 13 backward (the box filter 9 + 9, the max pool
    4 + 4), in every micro-batch of every step."""
    import torch

    from deepvariant_tpu_torch.ops import batch_norm_relu as bnr
    from deepvariant_tpu_torch.ops import pool
    from deepvariant_tpu_torch.training import train as train_lib
    from deepvariant_tpu_torch.training.config import TrainConfig

    batch = TRAIN_BATCH * accum
    cfg = TrainConfig(batch_size=batch, gradient_accumulation_steps=accum,
                      use_mixed_precision=dtype_name == "bfloat16")
    model, variables = train_lib.training_model(cfg, SHAPE, device)
    tx, _ = train_lib.make_optimizer(cfg, 10)
    state = train_lib.init_state(model, variables, tx)
    step = train_lib.make_train_step(model, tx, cfg)
    n = data["labels"].shape[0]
    rng = np.random.default_rng(SEED)
    order = [torch.from_numpy(rng.permutation(n)[:batch]).to(device)
             for _ in range(steps + warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bnr.batch_norm_relu.launches = 0
    pool.box3x3.launches = pool.max3x3s2.launches = 0
    losses = []
    for idx in order[:warmup]:
        state, loss, _ = step(state, {k: v.index_select(0, idx)
                                      for k, v in data.items()})
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for idx in order[warmup:]:
        state, loss, _ = step(state, {k: v.index_select(0, idx)
                                      for k, v in data.items()})
        losses.append(loss)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / steps
    peak = torch.cuda.max_memory_allocated()
    bn_launches = bnr.batch_norm_relu.launches
    if bn_launches != 4 * 94 * accum * (steps + warmup):
        raise AssertionError(
            f"train steps at {dtype_name} x{accum}: {bn_launches} batch "
            f"norm kernel launches in {steps + warmup} steps, not 4 x 94 x "
            f"{accum} a step")
    micro_batches = accum * (steps + warmup)
    pool_launches = (pool.box3x3.launches, pool.max3x3s2.launches)
    if pool_launches != (18 * micro_batches, 8 * micro_batches):
        raise AssertionError(
            f"train steps at {dtype_name} x{accum}: pool kernel launches "
            f"{pool_launches} (box, max) in {micro_batches} micro-batches, "
            "not 18 and 8 (13 + 13) a micro-batch")
    final_loss = float(torch.stack(losses).mean())
    if not math.isfinite(final_loss):
        raise AssertionError(f"train steps at {dtype_name} x{accum}: loss "
                             f"{final_loss}")
    step_flops = 3 * flops_per_example * batch
    share = step_flops / (ms / 1e3) / BF16_PEAK_FLOPS
    print(f"[train timing] {dtype_name}, batch {TRAIN_BATCH} x accumulation "
          f"{accum} (effective {batch}): {ms:.2f} ms/step, "
          f"{batch / (ms / 1e3):.1f} examples/s, peak memory "
          f"{peak / 2**30:.2f} GiB, {step_flops / 1e12:.3f} TFLOP/step = "
          f"{share:.2%} of the bf16 peak; mean loss {final_loss:.4f} over "
          f"{steps} steps; batch norm kernel launches {bn_launches} in "
          f"{steps + warmup} steps (4 x 94 x {accum} a step); pool kernel "
          f"launches {sum(pool_launches)} (26 x {accum} a step); {card}")
    return {"ms_per_step": ms, "examples_per_s": batch / (ms / 1e3),
            "bn_launches": bn_launches,
            "pool_launches": sum(pool_launches),
            "max_memory_allocated": peak, "bf16_peak_share": share,
            "tflop_per_step": step_flops / 1e12}


def profile_train_steps(data: dict, device, card: str, steps: int = 3
                        ) -> dict:
    """torch.profiler over `steps` bfloat16 train steps at batch
    TRAIN_BATCH (after two warm-up steps): the device's busy share of the
    window (the sum of the kernels' times over the window's wall time)
    and the ops that took most device time. A profile that returns no
    device records is printed, not failed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepvariant_tpu_torch.training import train as train_lib
    from deepvariant_tpu_torch.training.config import TrainConfig

    cfg = TrainConfig(batch_size=TRAIN_BATCH)
    model, variables = train_lib.training_model(cfg, SHAPE, device)
    tx, _ = train_lib.make_optimizer(cfg, 10)
    state = train_lib.init_state(model, variables, tx)
    step = train_lib.make_train_step(model, tx, cfg)
    idx = torch.arange(TRAIN_BATCH, device=device)
    batch = {k: v.index_select(0, idx) for k, v in data.items()}
    for _ in range(2):
        state, loss, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            state, loss, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    # The port's spans (`utils/trace.py`) are on under the profiler, and
    # their ranges come back as device events too: kernels only.
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    if not events:
        print(f"[train profile] the profiler returned no device records; "
              f"{card}")
        return {"train_profile_wall_ms": wall_ms}
    by_op = sorted((a for a in prof.key_averages()
                    if not getattr(a, "is_user_annotation", False)),
                   key=lambda a: -a.self_device_time_total)
    top = [(a.key[:60], a.self_device_time_total / 1e3 / steps)
           for a in by_op[:10] if a.self_device_time_total > 0]
    print(f"[train profile] bfloat16 x1, {steps} steps: wall "
          f"{wall_ms / steps:.2f} ms/step, kernels {busy_ms / steps:.2f} "
          f"ms/step, device busy {busy_ms / wall_ms:.1%}; {len(events)} "
          f"kernels; ms/step by op: " + "; ".join(f"{k} {v:.2f}"
                                                 for k, v in top)
          + f"; {card}")
    return {"train_profile_wall_ms": wall_ms / steps,
            "train_profile_kernel_ms": busy_ms / steps,
            "train_profile_busy_share": busy_ms / wall_ms,
            "train_profile_top_ops_ms": top}


def phase_training(tmp: str, device, card: str, labeled: dict) -> dict:
    """Phase 14: training on the card. (a) Phase 13's labeled examples
    through the train CLI (`wgs_test`, full width), the port's
    call_variants from its best.msgpack, and train_resident; (b) one
    float32 step of InceptionV3(7) at batch TRAIN_CHECK_BATCH on the card
    and on the CPU for sgd, adam and rmsprop against a float64 step on
    the card, and the bfloat16 step's loss; (c) ms per step at batch
    TRAIN_BATCH, bfloat16 and float32, accumulation 1 and 4, over
    TRAIN_EXAMPLES seeded examples resident on the card. The paint
    kernel must not be launched."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import read_cvos
    from deepvariant_tpu_torch.io import examples as example_codec
    from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
    from deepvariant_tpu_torch.models.checkpoint import (
        load_variables_for_examples,
    )
    from deepvariant_tpu_torch.models.inception_v3 import (
        normalize_pileup,
        tree_from_flax,
        to_flax_variables,
    )
    from deepvariant_tpu_torch.ops import pileup_paint as pp
    from deepvariant_tpu_torch.scripts import call_variants as cv_cli
    from deepvariant_tpu_torch.scripts import train as train_cli
    from deepvariant_tpu_torch.training import train_resident as resident_lib
    from deepvariant_tpu_torch.training.config import get_config
    from deepvariant_tpu_torch.training.data import DatasetConfig

    phase_start = time.time()
    pp.paint_pileup.launches = 0
    tag = "train"
    directory = os.path.join(tmp, "training")
    os.makedirs(directory)
    numbers = {}

    # -- (a) the labeled examples to a trained model and back --
    with TFRecordReader(labeled["train"]) as reader:
        records = list(reader)
    n = len(records)
    configs = {}
    for name in ("train", "tune"):
        configs[name] = os.path.join(directory, f"{name}.pbtxt")
        DatasetConfig(name=name, tfrecord_path=labeled[name],
                      num_examples=n).write(configs[name])
    exp = os.path.join(directory, "cli")
    argv = ["--config", "wgs_test", "--train_dataset_config",
            configs["train"], "--tune_dataset_config", configs["tune"],
            "--experiment_dir", exp, "--batch_size", str(TRAIN_CLI_BATCH),
            "--num_epochs", "2"]
    buf = io.StringIO()
    start = time.time()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    cli_s = time.time() - start
    epochs = [json.loads(line.split(": ", 1)[1])
              for line in buf.getvalue().splitlines()
              if line.startswith("epoch ")]
    ckpt_dir = os.path.join(exp, "checkpoints")
    files = sorted(os.listdir(ckpt_dir))
    last = read_flax(os.path.join(ckpt_dir, "ckpt-1.msgpack"))
    want_steps = 2 * min(n // TRAIN_CLI_BATCH, 50)
    losses = [e[k] for e in epochs for k in ("train/loss", "tune/loss")]
    print(f"[{tag}] train CLI (wgs_test, InceptionV3(7) at 100x221x7, "
          f"bfloat16, batch {TRAIN_CLI_BATCH}) on phase 13's {n} labeled "
          f"examples: {len(epochs)} epochs in {cli_s:.1f} s, losses "
          f"{[round(x, 4) for x in losses]}, step {int(last['step'])}, "
          f"files {files}; {card}")
    if rc != 0 or len(epochs) != 2 or not all(map(math.isfinite, losses)) \
            or int(last["step"]) != want_steps or files != [
                "best.msgpack", "ckpt-1.msgpack", "example_info.json"]:
        raise AssertionError(f"{tag}: the train CLI exited {rc} with "
                             f"{len(epochs)} epochs, losses {losses}, step "
                             f"{int(last['step'])} of {want_steps}, files "
                             f"{files}")
    # call_variants from the trained checkpoint, on the card.
    cvo = os.path.join(directory, "cvo.tfrecord.gz")
    quiet(cv_cli.main, ["--examples", labeled["train"], "--outfile", cvo,
                        "--checkpoint", ckpt_dir, "--batch_size",
                        str(BATCH)], tag + " call_variants")
    cvos = list(read_cvos(cvo))
    model, _ = load_variables_for_examples(ckpt_dir, labeled["train"],
                                           device=device)
    images = np.stack([example_codec.parse_example(r).image
                       for r in records])
    with torch.no_grad():
        want = model(normalize_pileup(torch.from_numpy(images).to(device),
                                      torch.float32)).cpu().numpy()
    got = np.asarray([c.genotype_probabilities for c in cvos])
    err = float(np.abs(got - want).max()) if len(got) == n else math.inf
    print(f"[{tag}] call_variants (bfloat16, batch {BATCH}) from "
          f"best.msgpack: {len(cvos)} CVOs for {n} examples; max |p - p of "
          f"the trained float32 model| {err:.5f} (limit "
          f"{TRAIN_CALL_PROB_ATOL}); {card}")
    if len(cvos) != n or err > TRAIN_CALL_PROB_ATOL:
        raise AssertionError(f"{tag}: {len(cvos)} CVOs for {n} examples, "
                             f"max error {err}")
    # The resident trainer on the same data.
    cfg = dataclasses.replace(
        get_config("wgs_test"), train_dataset_config=configs["train"],
        tune_dataset_config=configs["tune"], batch_size=TRAIN_CLI_BATCH,
        num_epochs=2)
    rexp = os.path.join(directory, "resident")
    logs = []
    start = time.time()
    results = resident_lib.train_resident(cfg, rexp, device=device,
                                          log_fn=logs.append)
    resident_s = time.time() - start
    with open(os.path.join(rexp, "history.json")) as f:
        history = json.load(f)
    rfiles = sorted(os.listdir(os.path.join(rexp, "checkpoints")))
    final = read_flax(os.path.join(rexp, "checkpoints", "final.msgpack"))
    rlosses = [h[k] for h in history for k in ("train/loss", "tune/loss")]
    print(f"[{tag}] train_resident (wgs_test, batch {TRAIN_CLI_BATCH}): "
          f"{len(history)} epochs in {resident_s:.1f} s, losses "
          f"{[round(x, 4) for x in rlosses]}, step {int(final['step'])}, "
          f"best epoch {results['best_epoch']}, files {rfiles}; {card}")
    if len(history) != 2 or not all(map(math.isfinite, rlosses)) or \
            int(final["step"]) != 2 * (n // TRAIN_CLI_BATCH) or rfiles != [
                "best.msgpack", "example_info.json", "final.msgpack"] or \
            set(final) != {"params", "batch_stats", "ema_params", "step"}:
        raise AssertionError(f"{tag}: train_resident wrote {rfiles}, "
                             f"history {history}")
    numbers.update({"train_cli_s": cli_s, "train_cli_examples": n,
                    "train_cli_steps": int(last["step"]),
                    "train_call_variants_max_err": err,
                    "train_resident_s": resident_s})

    # -- (b) one step, the card against the CPU and float64 --
    weights = to_flax_variables(seeded_model(SHAPE[2]))
    weights = {c: tree_from_flax(t) for c, t in weights.items()}
    rng = np.random.RandomState(SEED + 14)
    batch = {
        "images": rng.randint(0, 256, (TRAIN_CHECK_BATCH,) + SHAPE
                              ).astype(np.uint8),
        "labels": rng.randint(0, 3, TRAIN_CHECK_BATCH).astype(np.int32),
        "sample_weights": np.ones(TRAIN_CHECK_BATCH, np.float32),
        "variant_types": rng.randint(0, 3, TRAIN_CHECK_BATCH
                                     ).astype(np.int32)}
    cpu = torch.device("cpu")
    for optimizer, groups in TRAIN_CHECK_GROUPS.items():
        start_tree, card32, loss32 = one_train_step(
            weights, batch, optimizer, device, torch.float32)
        _, cpu32, cpu_loss = one_train_step(weights, batch, optimizer, cpu,
                                            torch.float32)
        _, card64, loss64 = one_train_step(weights, batch, optimizer, device,
                                           torch.float64)
        start_tree, card32, cpu32, card64 = map(
            flat_tree, (start_tree, card32, cpu32, card64))
        worst = {}
        for group in groups:
            bound = TRAIN_CHECK_RTOL[optimizer]
            d = {"card-f64": update_distance(card32, card64, start_tree,
                                             group),
                 "cpu-f64": update_distance(cpu32, card64, start_tree, group),
                 "card-cpu": update_distance(card32, cpu32, start_tree,
                                             group)}
            worst["/".join(group)] = d
            if max(d.values()) > bound:
                raise AssertionError(f"{tag}: {optimizer} {group}: update "
                                     f"distances {d} over {bound}")
        stats_err = max(float(np.max(np.abs(card32[k] - cpu32[k]) /
                                     (np.abs(cpu32[k]) + 1e-3)))
                        for k in cpu32 if k[0] == "batch_stats")
        counts_equal = all(np.array_equal(card32[k], cpu32[k])
                           for k in cpu32 if cpu32[k].dtype.kind == "i")
        loss_err = max(abs(loss32 - loss64), abs(cpu_loss - loss64)) / \
            abs(loss64)
        print(f"[{tag}] one float32 step, {optimizer}, batch "
              f"{TRAIN_CHECK_BATCH}: loss card {loss32:.6f}, CPU "
              f"{cpu_loss:.6f}, card float64 {loss64:.6f} (rel. err "
              f"{loss_err:.2e}, limit {TRAIN_LOSS_RTOL}); update distances "
              f"(relative L2, limit {TRAIN_CHECK_RTOL[optimizer]}): "
              + ", ".join(f"{g} " + "/".join(f"{v:.4f}" for v in d.values())
                          for g, d in worst.items())
              + f" (card-f64/cpu-f64/card-cpu); batch_stats rel. err "
              f"{stats_err:.2e}; counts equal {counts_equal}; {card}")
        if loss_err > TRAIN_LOSS_RTOL or stats_err > TRAIN_STATS_RTOL or \
                not counts_equal:
            raise AssertionError(f"{tag}: {optimizer} step: loss error "
                                 f"{loss_err}, batch_stats error {stats_err}"
                                 f", counts equal {counts_equal}")
        numbers[f"train_step_{optimizer}_distances"] = worst
    _, _, bf16_loss = one_train_step(weights, batch, "sgd", device,
                                     torch.float32, torch.bfloat16)
    _, _, f32_loss = one_train_step(weights, batch, "sgd", device,
                                    torch.float32)
    bf16_err = abs(bf16_loss - f32_loss) / abs(f32_loss)
    print(f"[{tag}] bfloat16 step loss {bf16_loss:.6f} against the float32 "
          f"step's {f32_loss:.6f}: rel. {bf16_err:.4f} (limit "
          f"{TRAIN_BF16_LOSS_RTOL}); {card}")
    if bf16_err > TRAIN_BF16_LOSS_RTOL:
        raise AssertionError(f"{tag}: bfloat16 loss {bf16_loss} against "
                             f"{f32_loss}")
    numbers["train_bf16_loss_rel_err"] = bf16_err

    # -- (c) ms per step at full width --
    flops = forward_flops_per_example(SHAPE)
    print(f"[{tag}] forward FLOPs per 100x221x7 example, counted from the "
          f"conv and head shapes: {flops / 1e9:.4f} GFLOP; a train step "
          f"counts 3x (forward, the input and the weight gradients)")
    rng = np.random.RandomState(SEED + 15)
    data = {
        "images": torch.from_numpy(rng.randint(
            0, 256, (TRAIN_EXAMPLES,) + SHAPE).astype(np.uint8)).to(device),
        "labels": torch.from_numpy(rng.randint(
            0, 3, TRAIN_EXAMPLES).astype(np.int32)).to(device),
        "sample_weights": torch.ones(TRAIN_EXAMPLES, device=device),
        "variant_types": torch.from_numpy(rng.randint(
            0, 3, TRAIN_EXAMPLES).astype(np.int32)).to(device)}
    print(f"[{tag}] {TRAIN_EXAMPLES} seeded examples resident on the card: "
          f"{data['images'].numel() / 1e6:.1f} MB")
    timing = {}
    for dtype_name, accum, steps, warmup in TRAIN_TIMINGS:
        timing[f"{dtype_name}_x{accum}"] = time_train_steps(
            data, dtype_name, accum, device, card, flops, steps, warmup)
    # cuDNN's autotuner, which the port leaves off, for comparison.
    torch.backends.cudnn.benchmark = True
    try:
        timing["bfloat16_x1_cudnn_benchmark"] = time_train_steps(
            data, "bfloat16", 1, device, card, flops, 8, 3)
    finally:
        torch.backends.cudnn.benchmark = False
    numbers.update(profile_train_steps(data, device, card))
    del data
    numbers["train_forward_gflop_per_example"] = flops / 1e9
    numbers["train_timing"] = timing
    launches = pp.paint_pileup.launches
    numbers["phase14_s"] = time.time() - phase_start
    print(f"[{tag}] paint kernel launches in phase 14: {launches}; phase 14 "
          f"{numbers['phase14_s']:.1f} s; {card}")
    if launches != 0:
        raise AssertionError(f"{tag}: the paint kernel was launched "
                             f"{launches} times by training")
    return numbers


def small_model_distance(got: dict, want: dict, init: dict) -> float:
    """Relative L2 distance between two small-model runs' moves from
    `init` (the flax tree both started from), over every leaf."""
    from deepvariant_tpu_torch.small_model.model import to_module_state

    start = {k: v.double().numpy()
             for k, v in to_module_state(init).items()}
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in start)
    den = sum(float(np.sum((want[k] - start[k]) ** 2)) for k in start)
    return (num / den) ** 0.5


def time_small_model_steps(n_features: int, device, card: str) -> dict:
    """ms per train step of the wgs small model (750x750, adamw) at its
    batch of 1024, back to back on the card (CUDA events), each step's
    batch gathered by index from SMALL_MODEL_TIMING_ROWS seeded rows
    held on the card, as `small_model.train.fit` gathers it."""
    import torch

    from deepvariant_tpu_torch.small_model import train as sm_train
    from deepvariant_tpu_torch.small_model.model import create_small_model

    config = sm_train.get_config("wgs")
    batch, n = config.batch_size, SMALL_MODEL_TIMING_ROWS
    steps, warmup = SMALL_MODEL_TIMING_STEPS
    rng = np.random.RandomState(SEED + 17)
    rows = rng.randint(0, 60, (n, n_features)).astype(np.float32)
    rows = (rows - rows.mean(axis=0)) / rows.std(axis=0)
    model, _ = create_small_model(n_features, config.hidden_layer_sizes,
                                  seed=SEED)
    model = model.to(device)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    optimizer = sm_train.make_optimizer(config, n // batch)
    opt_state = optimizer.init(params)
    x = torch.from_numpy(rows).to(device)
    y = torch.from_numpy(rng.randint(0, 3, n)).to(device)
    order = [torch.from_numpy(rng.permutation(n)[:batch]).to(device)
             for _ in range(steps + warmup)]
    for idx in order[:warmup]:
        params, opt_state, loss = sm_train.train_step(
            model, optimizer, params, opt_state, x[idx], y[idx])
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for idx in order[warmup:]:
        params, opt_state, loss = sm_train.train_step(
            model, optimizer, params, opt_state, x[idx], y[idx])
        losses.append(loss)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / steps
    mean_loss = float(torch.stack(losses).mean())
    if not math.isfinite(mean_loss):
        raise AssertionError(f"small-model train steps: loss {mean_loss}")
    sizes = [n_features, *config.hidden_layer_sizes, 3]
    flops = 3 * 2 * batch * sum(a * b for a, b in zip(sizes, sizes[1:]))
    share = flops / (ms / 1e3) / FP32_PEAK_FLOPS
    print(f"[small-model timing] wgs config ({n_features} features, "
          f"750x750, adamw), batch {batch} from {n} seeded rows on the "
          f"card: {ms:.4f} ms/step, {batch / (ms / 1e3):.0f} rows/s, "
          f"{flops / 1e9:.3f} GFLOP/step = {share:.2%} of the float32 peak "
          f"(67 TFLOP/s); mean loss {mean_loss:.4f} over {steps} steps "
          f"after {warmup} warm-up; {card}")
    return {"small_model_step_ms": ms,
            "small_model_rows_per_s": batch / (ms / 1e3),
            "small_model_fp32_peak_share": share}


def keras_by_hand(stand_in, channels: int):
    """InceptionV3(`channels`) with a keras model's weights placed by
    hand, independent of `models.keras_import`: the i-th Conv2D and
    BatchNormalization that keras created (conv2d_i,
    batch_normalization_i) go to the i-th ConvBN the module declares,
    the kernel (kh, kw, cin, cout) permuted to (cout, cin, kh, kw); the
    dense layer to the head, its kernel transposed."""
    import torch

    from deepvariant_tpu_torch.models import inception_v3 as iv3

    layers = {}

    def walk(model):
        for layer in model.layers:
            if hasattr(layer, "layers"):
                walk(layer)
            else:
                layers[layer.name] = layer.get_weights()

    walk(stand_in)
    model = iv3.InceptionV3(channels)
    units = [m for m in model.modules() if isinstance(m, iv3.ConvBN)]
    if sum(name.startswith("conv2d") for name in layers) != len(units):
        raise AssertionError(f"keras layers {sorted(layers)} against "
                             f"{len(units)} ConvBN units")
    with torch.no_grad():
        for i, unit in enumerate(units):
            suffix = f"_{i}" if i else ""
            kernel, = layers["conv2d" + suffix]
            beta, mean, var = layers["batch_normalization" + suffix]
            unit.conv.weight.copy_(torch.from_numpy(kernel).permute(
                3, 2, 0, 1))
            unit.bn.bias.copy_(torch.from_numpy(beta))
            unit.bn.mean.copy_(torch.from_numpy(mean))
            unit.bn.var.copy_(torch.from_numpy(var))
        kernel, bias = layers["dense"]
        model.classification.weight.copy_(torch.from_numpy(kernel).T)
        model.classification.bias.copy_(torch.from_numpy(bias))
    return model


def gate_threshold(bundle_dir: str, rows) -> float:
    """The median phred of the trained gate's calls on `rows`, rounded
    down to a tenth: a threshold that accepts about half of them."""
    from deepvariant_tpu_torch.core import genomics_math
    from deepvariant_tpu_torch.small_model.model import (
        SmallModelVariantCaller,
        create_small_model,
        load_bundle,
    )

    _, variables = create_small_model(rows.shape[1])
    variables, mean, scale = load_bundle(bundle_dir, rows.shape[1],
                                         variables)
    caller = SmallModelVariantCaller(None, variables)
    caller.feature_mean, caller.feature_scale = mean, scale
    probs = caller.classify(rows)
    phreds = [genomics_math.ptrue_to_bounded_phred(float(p.max() / p.sum()))
              for p in probs]
    return math.floor(statistics.median(phreds) * 10) / 10


def phase_small_model(tmp: str, device, card: str, bam_route: dict,
                      labeled: dict, checkpoint_dir: str):
    """Phase 15: the small model, run_oracle_inference, and the Keras
    import, export and stem rewrites, on phase 11's sample (phase 13's
    truth VCF and BED, rewritten from the same seed) and phase 14's
    trained checkpoint. Returns (numbers, the kernels-line entry of the
    gated stream with its launches)."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import read_cvos
    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
    from deepvariant_tpu_torch.make_examples.core import (
        MakeExamplesOptions,
        make_examples_runner,
    )
    from deepvariant_tpu_torch.make_examples.presets import apply_model_preset
    from deepvariant_tpu_torch.models import inception_v3 as iv3
    from deepvariant_tpu_torch.models.keras_import import (
        load_keras_into_model,
    )
    from deepvariant_tpu_torch.ops import pileup_paint as pp
    from deepvariant_tpu_torch.scripts import call_variants as cv_cli
    from deepvariant_tpu_torch.scripts import export_model
    from deepvariant_tpu_torch.scripts import make_examples as me_cli
    from deepvariant_tpu_torch.scripts import run_oracle_inference
    from deepvariant_tpu_torch.scripts import train_small_model as tsm_cli
    from deepvariant_tpu_torch.small_model import train as sm_train
    from deepvariant_tpu_torch.small_model.model import create_small_model
    from deepvariant_tpu_torch.testing import synthetic

    phase_start = time.time()
    tag = "small-model"
    directory = os.path.join(tmp, tag)
    os.makedirs(directory)
    sample, paths = bam_route["sample"], bam_route["paths"]
    truth = synthetic.write_truth_inputs(sample, directory, seed=SEED + 13)
    numbers = {}

    # -- A: training rows, then the small model trained on the card --
    atag = tag + " A"
    rows_path = os.path.join(directory, "rows.tfrecord")
    start = time.time()
    quiet(me_cli.main, [
        "--mode", "training", "--ref", paths["ref"], "--reads",
        paths["reads"], "--model_preset", "WGS", "--truth_variants",
        truth["truth"], "--confident_regions", truth["confident"],
        "--examples", os.path.join(directory, "labeled.tfrecord"),
        "--write_small_model_examples", "--small_model_examples", rows_path,
        "--small_model_vaf_context_window_size",
        str(SMALL_MODEL_WINDOW)], atag + " make_examples")
    rows_s = time.time() - start
    rows, labels = sm_train.read_training_examples(rows_path)
    n, n_features = rows.shape
    print(f"[{atag}] make_examples --mode training "
          f"--write_small_model_examples (window {SMALL_MODEL_WINDOW}): "
          f"{n} rows of {n_features} features in {rows_s:.1f} s, labels "
          f"0/1/2 {np.bincount(labels, minlength=3).tolist()}")
    if n < 16 or n_features != 19 + SMALL_MODEL_WINDOW:
        raise AssertionError(f"{atag}: {n} rows of {n_features} features")
    bundle = os.path.join(directory, "small_model")
    start = time.time()
    quiet(tsm_cli.main, ["--train_examples", rows_path, "--output_dir",
                         bundle, "--config", "wgs"], atag + " train CLI")
    cli_s = time.time() - start
    with open(os.path.join(bundle, "small_model.json")) as f:
        info = json.load(f)
    if info["hidden_layer_sizes"] != [750, 750] or \
            info["num_features"] != n_features or \
            not math.isfinite(info["metrics"]["train_loss"]):
        raise AssertionError(f"{atag}: the train CLI wrote {info}")
    # The training loop on the card, held to float64 on the card and on
    # the CPU from one init over the same normalized rows; TF32 and
    # bfloat16 controls show what the limit would catch.
    config = sm_train.get_config("wgs")
    mean, scale = rows.mean(axis=0), rows.std(axis=0)
    scale[scale == 0] = 1.0
    normalized = (rows - mean) / scale
    _, init = create_small_model(n_features, seed=SEED)
    runs = {}
    for name, where, dtype in (
            ("card f32", device, torch.float32),
            ("card f64", device, torch.float64),
            ("CPU f64", "cpu", torch.float64),
            ("card TF32", device, torch.float32),
            ("card bf16", device, torch.bfloat16)):
        torch.backends.cuda.matmul.allow_tf32 = name == "card TF32"
        try:
            _, params, _ = sm_train.fit(normalized, labels, config,
                                        device=where, initial_variables=init,
                                        dtype=dtype)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        runs[name] = {k: v.double().cpu().numpy() for k, v in params.items()}
    distances = {f"{a} vs {b}": small_model_distance(runs[a], runs[b], init)
                 for a, b in (("card f32", "card f64"),
                              ("card f32", "CPU f64"),
                              ("card f64", "CPU f64"),
                              ("card TF32", "card f64"),
                              ("card bf16", "card f64"))}
    print(f"[{atag}] train_small_model --config wgs --device cuda (750x750, "
          f"{info['metrics']['epoch'] + 1} epochs of batch {min(1024, n)}) "
          f"in {cli_s:.2f} s, train accuracy "
          f"{info['metrics']['train_accuracy']:.3f}; the loop's params "
          f"after {config.num_epochs} epochs from one init, relative L2 of "
          f"the update: " + ", ".join(f"{k} {v:.3e}"
                                      for k, v in distances.items())
          + f" (limits: float32 {SMALL_MODEL_F64_RTOL}, float64 "
          f"{SMALL_MODEL_F64_PAIR_RTOL}; the controls must exceed "
          f"{SMALL_MODEL_F64_RTOL}); {card}")
    if not (distances["card f32 vs card f64"] <= SMALL_MODEL_F64_RTOL
            and distances["card f32 vs CPU f64"] <= SMALL_MODEL_F64_RTOL
            and distances["card f64 vs CPU f64"]
            <= SMALL_MODEL_F64_PAIR_RTOL
            and not distances["card TF32 vs card f64"]
            <= SMALL_MODEL_F64_RTOL
            and not distances["card bf16 vs card f64"]
            <= SMALL_MODEL_F64_RTOL):
        raise AssertionError(f"{atag}: the small model's training moved: "
                             f"{distances}")
    timing = time_small_model_steps(n_features, device, card)
    numbers.update({"small_model_rows": n, "small_model_features": n_features,
                    "small_model_train_cli_s": cli_s,
                    "small_model_distances": distances, **timing})

    # -- B: the gate on the main path, staged and streamed --
    btag = tag + " B"
    threshold = gate_threshold(bundle, rows)
    gate_flags = (f"small_model_snp_gq_threshold={threshold},"
                  f"small_model_indel_gq_threshold={threshold}")
    options = apply_model_preset(MakeExamplesOptions(
        reads_filename=paths["reads"], ref_filename=paths["ref"],
        call_small_model_examples=True, trained_small_model_path=bundle,
        small_model_snp_gq_threshold=threshold,
        small_model_indel_gq_threshold=threshold,
        small_model_vaf_context_window_size=SMALL_MODEL_WINDOW), "WGS")
    gated, sm_cvos = [], []
    counts = make_examples_runner(options, plan_sink=gated.append,
                                  small_model_cvo_sink=sm_cvos.append)
    ungated = bam_route["plans"]
    print(f"[{btag}] the gate at GQ {threshold} (the median phred of its "
          f"calls on the training rows): {len(sm_cvos)} small-model CVOs, "
          f"{len(gated)} plans left of phase 11's {len(ungated)} "
          f"(the runner's counts {counts})")
    if not 0 < len(sm_cvos) < len(ungated) or \
            len(gated) != len(ungated) - len(sm_cvos):
        raise AssertionError(f"{btag}: {len(sm_cvos)} CVOs, {len(gated)} "
                             f"plans of {len(ungated)}")

    def argv(name, *more):
        return ["--ref", paths["ref"], "--reads", paths["reads"],
                "--output_vcf", os.path.join(directory, f"{name}.vcf.gz"),
                "--output_gvcf", os.path.join(directory, f"{name}.g.vcf.gz"),
                "--checkpoint", bam_route["checkpoint"], "--batch_size",
                str(BATCH), "--num_shards", str(STREAM_WORKERS),
                "--intermediate_results_dir", os.path.join(directory, name),
                "--call_small_model_examples",
                "--trained_small_model_path", bundle,
                "--make_examples_extra_args", gate_flags, *more]

    _, staged_s, _ = run_deepvariant_cli(argv("staged"), btag + " staged",
                                         card)
    staged_dir = os.path.join(directory, "staged")
    staged_sm = list(read_cvos(os.path.join(
        staged_dir, f"small_model_cvos.tfrecord@{STREAM_WORKERS}.gz")))
    staged_cvos = list(read_cvos(os.path.join(
        staged_dir, "call_variants_output.tfrecord.gz"))) + staged_sm
    seen, restore = record_stream_cvos()
    pp.paint_pileup.launches = 0
    try:
        text, stream_s, _ = run_deepvariant_cli(
            argv("stream", "--stream"), btag + " stream", card)
    finally:
        restore()
    launches = pp.paint_pileup.launches
    (stream_cvos, stats), = seen
    painted = stats.num_examples
    batches = -(-painted // BATCH)
    if "encoder=device" not in text or painted != len(gated) or \
            launches != batches or stats.num_small_model_cvos != \
            len(sm_cvos) or len(staged_sm) != len(sm_cvos) or \
            sorted(c.encode() for c in staged_sm) != \
            sorted(c.encode() for c in sm_cvos):
        raise AssertionError(
            f"{btag}: the stream painted {painted} plans (the runner "
            f"{len(gated)}) in {launches} launches for {batches} batches; "
            f"small-model CVOs: stream {stats.num_small_model_cvos}, staged "
            f"{len(staged_sm)}, runner {len(sm_cvos)}")
    vcfs = {}
    for name, cvos in (("staged", staged_cvos), ("stream", stream_cvos)):
        vcfs[name] = os.path.join(directory, f"{name}.vcf.gz")
        check_vcf(vcfs[name], cvos, paths["ref"], "default",
                  f"{btag} {name}", card)
        check_gvcf(os.path.join(directory, f"{name}.g.vcf.gz"), vcfs[name],
                   paths["ref"], f"{btag} {name}", card)
    moved = vcfs_agree(vcfs["staged"], staged_cvos, vcfs["stream"],
                       stream_cvos, btag + " staged VCF vs streamed VCF")
    predictor = PlanPredictor(bam_route["model"], options.pileup_options,
                              batch_size=BATCH, device=device)
    entry = from_files_entry("pileup_paint_plan_small_model_gate", predictor,
                             [p.plan for p in gated], btag, card)
    entry["launches"] = launches
    print(f"[{btag}] run_deepvariant --call_small_model_examples: staged "
          f"{staged_s:.2f} s, streamed {stream_s:.2f} s; {len(sm_cvos)} "
          f"small-model CVOs; {painted} plans painted in {launches} launches "
          f"of the plan form; VCF records moved by bfloat16: {moved}; "
          f"{card}")
    numbers.update({"small_model_gate_threshold": threshold,
                    "small_model_cvos": len(sm_cvos),
                    "small_model_plans_painted": painted,
                    "small_model_plans_ungated": len(ungated),
                    "small_model_staged_s": staged_s,
                    "small_model_stream_s": stream_s,
                    "small_model_vcf_records_moved_by_bf16": moved,
                    "small_model_plan_form_launches": launches})

    # -- C: export, the Keras import, the stem rewrites --
    ctag = tag + " C"
    exported = os.path.join(directory, "exported")
    quiet(export_model.main, ["--checkpoint", os.path.join(
        checkpoint_dir, "best.msgpack"), "--output_dir", exported],
        ctag + " export_model")
    cvo_files = {}
    for name, ckpt in (("best", checkpoint_dir), ("exported", exported)):
        cvo_files[name] = os.path.join(directory, f"cvo-{name}.tfrecord")
        quiet(cv_cli.main, ["--examples", labeled["train"], "--outfile",
                            cvo_files[name], "--checkpoint", ckpt,
                            "--batch_size", str(BATCH), "--use_ema"],
              f"{ctag} call_variants {name}")
    got = [c.encode() for c in read_cvos(cvo_files["exported"])]
    want = [c.encode() for c in read_cvos(cvo_files["best"])]
    print(f"[{ctag}] export_model from phase 14's best.msgpack (EMA), then "
          f"call_variants --checkpoint <exported> on the card: {len(got)} "
          f"CVOs, equal to best.msgpack's with --use_ema: {got == want}")
    if got != want or not got:
        raise AssertionError(f"{ctag}: the exported bundle's CVOs differ")
    # A numpy stand-in of keras layers through the import to the card,
    # against the same weights placed by hand.
    stand_in = synthetic.keras_inception_stand_in(SEED, SHAPE[2])
    imported, _ = load_keras_into_model(stand_in, SHAPE[2], device=device)
    direct = iv3.prepare_for_inference(keras_by_hand(stand_in, SHAPE[2]),
                                       device, torch.float32)
    rng = np.random.RandomState(SEED + 15)
    images = torch.from_numpy(rng.randint(0, 256, (16,) + SHAPE).astype(
        np.uint8)).to(device)
    x = iv3.normalize_pileup(images, torch.float32)
    want_state = direct.state_dict()
    got_state = imported.state_dict()
    same_weights = set(got_state) == set(want_state) and all(
        torch.equal(got_state[k], want_state[k]) for k in want_state)
    with torch.no_grad():
        same = same_weights and torch.equal(imported(x), direct(x))
    print(f"[{ctag}] a seeded numpy stand-in of keras InceptionV3 layers "
          f"through keras_import on the card == its weights placed by hand "
          f"(keras's creation order onto the module's declared order, "
          f"kernels transposed by hand), weights and probabilities: {same}")
    if not same:
        raise AssertionError(f"{ctag}: the keras import differs")
    # The stem rewrites: folded, padded to 8 channels, space-to-depth.
    plain = iv3.prepare_for_inference(seeded_model(SHAPE[2]), device,
                                      torch.float32)
    folded = iv3.fold_batch_norm(plain)
    rewritten = iv3.convert_stem_to_s2d(iv3.pad_stem_input_channels(
        folded, 8))
    images8 = torch.cat([images, torch.zeros_like(images[..., :1])], -1)
    with torch.no_grad():
        base = plain(x)
        s2d_err = float((rewritten(iv3.normalize_pileup(
            images8, torch.float32)) - base).abs().max())
    print(f"[{ctag}] folded + padded + space-to-depth InceptionV3(7) on the "
          f"card against the plain graph, float32: max |dp| {s2d_err:.2e} "
          f"(limit {S2D_ATOL})")
    if s2d_err > S2D_ATOL:
        raise AssertionError(f"{ctag}: the stem rewrites moved the "
                             f"probabilities by {s2d_err}")
    batch = torch.from_numpy(np.random.RandomState(SEED + 16).randint(
        0, 256, (BATCH,) + SHAPE).astype(np.uint8)).to(device)
    batch8 = torch.cat([batch, torch.zeros_like(batch[..., :1])], -1)
    bf16 = {}
    for name, model, data in (
            ("folded", folded, batch),
            ("folded_pad8_s2d", rewritten, batch8)):
        model = iv3.prepare_for_inference(model, device, torch.bfloat16)
        inputs = iv3.normalize_pileup(data, torch.bfloat16)
        with torch.inference_mode():
            bf16[name] = device_ms(lambda: model(inputs), reps=5, repeats=3)
    print(f"[{ctag}] bfloat16 forward at batch {BATCH}: folded "
          f"{bf16['folded']:.3f} ms, folded + padded + space-to-depth "
          f"{bf16['folded_pad8_s2d']:.3f} ms; {card}")
    numbers.update({"s2d_max_abs_err": s2d_err,
                    "bf16_forward_ms": bf16})

    # -- D: run_oracle_inference --
    dtag = tag + " D"
    oracle_vcf = os.path.join(directory, "oracle.vcf.gz")
    start = time.time()
    quiet(run_oracle_inference.main, [
        "--model_type", "WGS", "--ref", paths["ref"], "--reads",
        paths["reads"], "--output_vcf", oracle_vcf, "--truth_variants",
        truth["truth"], "--confident_regions", truth["confident"],
        "--num_shards", "2", "--intermediate_results_dir",
        os.path.join(directory, "oracle")], dtag)
    oracle_s = time.time() - start
    matched, missing, multi = oracle_agreement(oracle_vcf, truth, dtag)
    print(f"[{dtag}] run_oracle_inference (2 shards) in {oracle_s:.1f} s: "
          f"{matched} confident truth records called with their genotype, "
          f"{multi} at multiallelic candidates (one alt set's record), "
          f"{missing} without a candidate; {card}")
    numbers.update({"oracle_s": oracle_s, "oracle_matched": matched,
                    "oracle_multiallelic": multi,
                    "oracle_without_candidate": missing,
                    "phase15_s": time.time() - phase_start})
    print(f"[{tag}] phase 15 {numbers['phase15_s']:.1f} s; {card}")
    return numbers, entry


def oracle_agreement(oracle_vcf: str, truth: dict, tag: str) -> tuple:
    """Every confident truth record at a biallelic oracle record must be
    called with its truth genotype. Returns (matched, truth records with
    no candidate, records at multiallelic candidates)."""
    confident = []
    with open(truth["confident"]) as f:
        for line in f:
            name, start, end = line.split()[:3]
            confident.append((name, int(start), int(end)))

    def alleles(fields):
        bases = [fields[3]] + fields[4].split(",")
        gt = fields[9].split(":")[0].replace("|", "/").split("/")
        return sorted(bases[int(i)] for i in gt if i != ".")

    want = {}
    for line in vcf_records(truth["truth"]):
        fields = line.split("\t")
        pos = int(fields[1]) - 1
        if fields[6] == "RefCall" or not any(
                n == fields[0] and s <= pos < e for n, s, e in confident):
            continue
        want[(fields[0], pos)] = alleles(fields)
    matched = multi = 0
    for line in vcf_records(oracle_vcf):
        fields = line.split("\t")
        key = (fields[0], int(fields[1]) - 1)
        if key not in want:
            continue
        expect = want.pop(key)
        if alleles(fields) == expect:
            matched += 1
        elif "," in fields[4]:
            multi += 1
        else:
            raise AssertionError(f"{tag}: the oracle calls {line} against "
                                 f"the truth's {expect}")
    if matched < 10:
        raise AssertionError(f"{tag}: {matched} truth records called")
    return matched, len(want), multi


# -- phase 16: multi-sample make_examples and the one-step scripts -----------

def multisample_inputs(directory: str, tag: str) -> dict:
    """The seeded family, tumour/normal pair and pangenome panel over
    MULTISAMPLE_CONTIGS, written with the port's writers: one FASTA per
    set, a BAM per sample, the panel as a GBZ, and a panel of normals
    (the normal's planted variants in the cohort forms of
    `synthetic.write_vcf_inputs`)."""
    from deepvariant_tpu_torch.core import types
    from deepvariant_tpu_torch.io import bam, bam_writer, gbz
    from deepvariant_tpu_torch.testing import synthetic

    start = time.time()
    writers = (types, bam, bam_writer)
    paths = {}
    family = synthetic.synthetic_family(
        SEED + 16, MULTISAMPLE_CONTIGS, variant_spacing=MULTISAMPLE_SPACING)
    pair = synthetic.synthetic_tumor_normal(
        SEED + 17, MULTISAMPLE_CONTIGS, variant_spacing=MULTISAMPLE_SPACING)
    pangenome = synthetic.synthetic_pangenome(
        SEED + 18, MULTISAMPLE_CONTIGS, variant_spacing=MULTISAMPLE_SPACING)
    reads = 0
    for name, samples in (("family", family), ("pair", pair),
                          ("pangenome", pangenome)):
        d = os.path.join(directory, name)
        os.makedirs(d)
        first = next(s for s in samples.values() if "reads" in s)
        paths[name] = {"ref": synthetic.write_fasta(
            first, os.path.join(d, "ref.fa"))}
        for role, sample in samples.items():
            if isinstance(sample, dict) and "reads" in sample:
                paths[name][role] = synthetic.write_bam(
                    sample, os.path.join(d, f"{role}.bam"), *writers)
                reads += len(sample["reads"]["name"])
    paths["pangenome"]["panel"] = synthetic.write_panel_gbz(
        pangenome["panel"], os.path.join(directory, "pangenome", "panel.gbz"),
        gbz)
    paths["pair"]["pon"] = synthetic.write_vcf_inputs(
        pair["normal"], os.path.join(directory, "pair"), seed=SEED + 19,
        population=True)["population"]
    print(f"[{tag}] wrote a family (3 samples), a tumour/normal pair "
          f"({len(pair['somatic']['chr1'])} somatic variants at allele "
          f"fractions {min(v['vaf'] for v in pair['somatic']['chr1'])}-"
          f"{max(v['vaf'] for v in pair['somatic']['chr1'])}) and a read "
          f"set with a {len(pangenome['panel']['haplotypes'])}-haplotype "
          f"GBZ panel over {MULTISAMPLE_CONTIGS}: {reads} reads in "
          f"{time.time() - start:.1f} s")
    return paths


def collect_trio_plans(stacks: list, builders: list):
    """Wrap MultiSampleRegionProcessor._stacked_examples_for_candidate so
    that beside each stacked example it keeps the plan of every sample's
    plane (that sample's ExamplesBuilder and support, as the host painter
    gets them): `stacks` gets one list per runner call, of tuples of
    plans, and `builders` that call's ExamplesBuilders. Returns a
    function that puts the plain method back."""
    from deepvariant_tpu_torch.make_examples import multisample as ms
    from deepvariant_tpu_torch.make_examples.variant_caller import (
        DeepVariantCall,
    )

    cls = ms.MultiSampleRegionProcessor
    plain = cls._stacked_examples_for_candidate

    def with_plans(self, dv_call, batches, counters=None, label=None):
        out = plain(self, dv_call, batches, counters, label=label)
        if not stacks or builders[-1] is not self.builders:
            stacks.append([])
            builders.append(self.builders)
        planes = []
        for i, (builder, batch) in enumerate(zip(self.builders, batches)):
            call = dv_call
            if i != self.main_sample_index:
                support, refs = self._main.caller.support_from_counter(
                    counters[i], dv_call) if counters is not None \
                    else ({}, [])
                call = DeepVariantCall(
                    variant=dv_call.variant, allele_support=support,
                    ref_support=refs, allele_keys=dv_call.allele_keys)
            planes.append(list(builder.build_plans_for_candidate(call,
                                                                 batch)))
        if any(len(p) != len(out) for p in planes):
            raise AssertionError("a plane's plans and the stacked examples "
                                 "of a candidate differ in number")
        stacks[-1].extend(zip(*planes))
        return out

    cls._stacked_examples_for_candidate = with_plans
    return lambda: setattr(cls, "_stacked_examples_for_candidate", plain)


def check_trio_planes(stacks, builders, records, model, device, tag: str):
    """Every stacked trio example equals the CUDA plan form's planes of
    the same candidate, painted sample by sample (one launch per sample
    per batch) and stacked, bit for bit. Returns the child plane's
    PlanPredictor and plans (for the kernels-line entry)."""
    import torch

    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.io import examples as example_codec

    if len(records) != len(stacks) or not records:
        raise AssertionError(f"{tag}: {len(records)} examples, "
                             f"{len(stacks)} stacks of plans")
    predictors = [PlanPredictor(model, b.pileup_options, batch_size=BATCH,
                                device=device) for b in builders]
    mismatched = 0
    with torch.inference_mode():
        for i in range(0, len(stacks), BATCH):
            chunk = stacks[i:i + BATCH]
            planes = [p.encode([s[k].plan for s in chunk])[:len(chunk)]
                      .cpu().numpy() for k, p in enumerate(predictors)]
            images = np.concatenate(planes, axis=1)
            for k, stack in enumerate(chunk):
                ex = example_codec.parse_example(records[i + k])
                if locus_key(ex.variant, ex.alt_allele_indices) != \
                        locus_key(stack[0].variant, stack[0].alt_indices):
                    raise AssertionError(f"{tag}: example {i + k} and its "
                                         "plans are of other candidates")
                if not np.array_equal(ex.image, images[k]):
                    mismatched += 1
    print(f"[{tag}] {len(records)} stacked examples "
          f"({'+'.join(str(b.pileup_options.height) for b in builders)} "
          f"rows) == the CUDA plan form's planes of the same candidates, "
          f"painted sample by sample and stacked, bit for bit: "
          f"{mismatched == 0} ({mismatched} differ)")
    if mismatched:
        raise AssertionError(f"{tag}: {mismatched} stacked examples differ "
                             "from the plan form's planes")
    child = [b.pileup_options.height for b in builders].index(
        max(b.pileup_options.height for b in builders))
    return predictors[child], [s[child].plan for s in stacks]


def run_pipeline(main, argv, tag: str, tally: dict, card: str) -> float:
    """A one-step product script's `main` in this process (its output
    printed under `tag`), with each stage's seconds added to `tally`;
    returns its wall seconds."""
    from deepvariant_tpu_torch.make_examples import core
    from deepvariant_tpu_torch.make_examples import multisample as ms
    from deepvariant_tpu_torch.scripts import call_variants as cv_cli
    from deepvariant_tpu_torch.scripts import postprocess_variants as pp_cli

    examples = lambda args, result: result["examples"]  # noqa: E731
    undo = [wrap(ms, "make_multisample_examples_runner", tally, "stage1",
                 examples),
            wrap(core, "make_examples_runner", tally, "stage1", examples),
            wrap(cv_cli, "main", tally, "stage2"),
            wrap(pp_cli, "main", tally, "stage3")]
    start = time.time()
    try:
        quiet(main, argv, tag)
    finally:
        for u in undo:
            u()
    seconds = time.time() - start
    print(f"[{tag}] {tally['stage1']} examples; stage 1 "
          f"{tally['stage1_s']:.2f} s, stage 2 {tally['stage2_s']:.2f} s, "
          f"stage 3 {tally['stage3_s']:.2f} s, {seconds:.2f} s in all, "
          f"{tally['stage1'] / seconds:.2f} examples/s from the BAMs to the "
          f"VCFs; host CPUs {os.cpu_count()}, beside {card}")
    return seconds


def float32_beside(examples: str, cvo_bf16: str, vcf_bf16: str,
                   pp_argv: list, checkpoint: str, device, tag: str) -> dict:
    """A script's examples once more through call_variants in float32
    (TF32 off) on the card and on the CPU: the largest probability gap
    between the two, and the VCF records that the card's bfloat16 CVOs
    move against its float32 ones (the script's stage 3 on each)."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import (
        call_variants,
        read_cvos,
    )
    from deepvariant_tpu_torch.models.checkpoint import (
        load_variables_for_examples,
    )
    from deepvariant_tpu_torch.scripts import postprocess_variants as pp_cli

    cvos = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        model, _ = load_variables_for_examples(checkpoint, examples,
                                               device=dev)
        path = cvo_bf16.replace(".tfrecord", f".f32_{where}.tfrecord")
        call_variants(examples, path, model, batch_size=BATCH, device=dev,
                      dtype=torch.float32)
        cvos[where] = {locus_key(c.variant, c.alt_allele_indices): c
                       for c in read_cvos(path)}
        cvos[where + "_path"] = path
    bf16 = {locus_key(c.variant, c.alt_allele_indices): c
            for c in read_cvos(cvo_bf16)}
    if not (set(cvos["card"]) == set(cvos["cpu"]) == set(bf16)):
        raise AssertionError(f"{tag}: the float32 and bfloat16 CVOs are of "
                             "other candidates")
    gap = max(float(np.abs(np.subtract(
        cvos["card"][k].genotype_probabilities,
        cvos["cpu"][k].genotype_probabilities)).max()) for k in bf16)
    bf16_gap = max(float(np.abs(np.subtract(
        cvos["card"][k].genotype_probabilities,
        bf16[k].genotype_probabilities)).max()) for k in bf16)
    vcf_f32 = vcf_bf16.replace(".vcf", ".f32.vcf")
    argv = list(pp_argv)
    argv[argv.index("--infile") + 1] = cvos["card_path"]
    argv[argv.index("--outfile") + 1] = vcf_f32
    quiet(pp_cli.main, argv, tag + " f32 stage 3")
    a, b = vcf_records(vcf_bf16), vcf_records(vcf_f32)
    if len(a) != len(b) or not a:
        raise AssertionError(f"{tag}: {len(a)} bfloat16 and {len(b)} float32 "
                             "VCF records")
    moved = sum(x != y for x, y in zip(a, b))
    if not np.isfinite(gap) or gap > F32_CARD_CPU_ATOL:
        raise AssertionError(f"{tag}: the card's float32 CVOs are {gap} from "
                             f"the CPU's (limit {F32_CARD_CPU_ATOL})")
    print(f"[{tag}] {len(bf16)} CVOs: float32 card vs CPU max |dp| {gap:.3e} "
          f"(limit {F32_CARD_CPU_ATOL}); bfloat16 vs float32 on the card max "
          f"|dp| {bf16_gap:.3e}; {moved} of {len(a)} VCF records moved by "
          "bfloat16")
    return {"cvos": len(bf16), "f32_card_cpu_gap": gap,
            "bf16_f32_gap": bf16_gap, "vcf_records": len(a),
            "bf16_moved_records": moved}


def time_stacked_cnn(examples: str, tag: str, device, card: str) -> dict:
    """The bfloat16 InceptionV3(7) at the examples' height, batch BATCH of
    the examples repeated, on the card (CUDA events): ms per batch back
    to back and call by call, and the peak of allocated memory."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import Predictor
    from deepvariant_tpu_torch.io import examples as example_codec

    images = [example_codec.parse_example(r).image
              for r in example_records(examples)]
    batch = np.stack([images[i % len(images)] for i in range(BATCH)])
    predictor = Predictor(seeded_model(batch.shape[-1]), BATCH, device,
                          torch.bfloat16)
    x = torch.from_numpy(batch).to(device)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        predictor.forward(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        numbers = {
            "cnn_device_ms": device_ms(lambda: predictor.forward(x), reps=3),
            "cnn_ms": time_ms(lambda: predictor.forward(x), reps=10),
            "peak_allocated_gib": peak / 2 ** 30,
            "peak_above_resident_gib": (peak - base) / 2 ** 30,
        }
    h, w, c = batch.shape[1:]
    print(f"[{tag}] bfloat16 InceptionV3({c}) at {h}x{w}x{c}, batch {BATCH} "
          f"of {len(images)} examples repeated: {numbers['cnn_device_ms']:.3f}"
          f" ms back to back, {numbers['cnn_ms']:.3f} ms call by call; peak "
          f"allocated {numbers['peak_allocated_gib']:.3f} GiB "
          f"({numbers['peak_above_resident_gib']:.3f} above the weights and "
          f"the batch); {card}")
    del predictor, x
    return {f"{k}_{h}": v for k, v in numbers.items()}


def phase_multisample(tmp: str, device, card: str):
    """Phase 16: multi-sample make_examples and the three one-step
    product scripts on the card. Returns (numbers, the kernels-line entry
    of the trio planes painted by the plan form, with its launches)."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import read_cvos
    from deepvariant_tpu_torch.io import examples as example_codec
    from deepvariant_tpu_torch.models.checkpoint import save_variables
    from deepvariant_tpu_torch.ops import pileup_paint as pp
    from deepvariant_tpu_torch.scripts import multisample_make_examples
    from deepvariant_tpu_torch.scripts import run_deepsomatic
    from deepvariant_tpu_torch.scripts import run_deeptrio
    from deepvariant_tpu_torch.scripts import run_pangenome_aware_deepvariant

    phase_start = time.time()
    tag = "multisample"
    directory = os.path.join(tmp, tag)
    paths = multisample_inputs(directory, tag)
    model = seeded_model(MULTISAMPLE_CHANNELS)
    # No example_info.json beside it: one checkpoint for every height.
    checkpoint = os.path.join(directory, "ckpt", "model.msgpack")
    save_variables(checkpoint, model)
    numbers = {}

    # -- run_deeptrio: child and both parents, 40/60/40 rows --
    ttag = tag + " deeptrio"
    f = paths["family"]
    out = os.path.join(directory, "deeptrio")
    stacks, builders, tally = [], [], {}
    undo = collect_trio_plans(stacks, builders)
    try:
        seconds = run_pipeline(run_deeptrio.main, [
            "--ref", f["ref"], "--reads_child", f["child"],
            "--reads_parent1", f["parent1"], "--reads_parent2",
            f["parent2"],
            "--output_vcf_child", os.path.join(out, "child.vcf.gz"),
            "--output_vcf_parent1", os.path.join(out, "parent1.vcf.gz"),
            "--output_vcf_parent2", os.path.join(out, "parent2.vcf.gz"),
            "--checkpoint_child", checkpoint, "--checkpoint_parent",
            checkpoint, "--batch_size", str(BATCH), "--device", device.type,
            "--intermediate_results_dir", os.path.join(out, "work")],
            ttag, tally, card)
    finally:
        undo()
    numbers["deeptrio"] = dict(tally, seconds=seconds)
    roles = ("child", "parent1", "parent2")
    if len(stacks) != 3:
        raise AssertionError(f"{ttag}: {len(stacks)} runner calls, not 3")
    pp.paint_pileup.launches = 0
    planes = {}
    for role, target, target_builders in zip(roles, stacks, builders):
        planes[role] = check_trio_planes(
            target, target_builders, example_records(os.path.join(
                out, "work", f"make_examples_{role}.tfrecord.gz")),
            model, device, f"{ttag} {role}")
    launches = pp.paint_pileup.launches
    print(f"[{ttag}] plan form launches painting the three targets' planes: "
          f"{launches}")
    predictor, plans = planes["child"]
    entry = from_files_entry("pileup_paint_plan_trio_planes", predictor,
                             plans, ttag, card)
    entry["launches"] = launches
    del predictor, planes

    routes = {}
    for role in roles:
        routes[f"deeptrio_{role}"] = dict(
            examples=os.path.join(out, "work",
                                  f"make_examples_{role}.tfrecord.gz"),
            cvos=os.path.join(out, "work", f"cvo_{role}.tfrecord.gz"),
            vcf=os.path.join(out, f"{role}.vcf.gz"), sample=role, ref=f["ref"],
            extra=[], height=140)
    # -- run_deepsomatic: the pair with a panel of normals, the tumour alone --
    s = paths["pair"]
    for name, more in (("deepsomatic", ["--reads_normal", s["normal"],
                                        "--pon_filtering", s["pon"]]),
                       ("deepsomatic_tumor_only", [])):
        out = os.path.join(directory, name)
        tally = {}
        seconds = run_pipeline(run_deepsomatic.main, [
            "--ref", s["ref"], "--reads_tumor", s["tumor"], *more,
            "--output_vcf", os.path.join(out, "somatic.vcf.gz"),
            "--checkpoint", checkpoint, "--batch_size", str(BATCH),
            "--device", device.type,
            "--intermediate_results_dir", os.path.join(out, "work")],
            f"{tag} {name}", tally, card)
        numbers[name] = dict(tally, seconds=seconds)
        routes[name] = dict(
            examples=os.path.join(out, "work",
                                  "make_examples_somatic.tfrecord.gz"),
            cvos=os.path.join(out, "work", "cvo_somatic.tfrecord.gz"),
            vcf=os.path.join(out, "somatic.vcf.gz"), sample="tumor",
            ref=s["ref"], extra=["--process_somatic"] + (
                ["--pon_filtering", s["pon"]] if more else []),
            height=200 if more else 100)
    filters = [line.split("\t")[6] for line in
               vcf_records(routes["deepsomatic"]["vcf"])]
    numbers["deepsomatic_filters"] = {
        f: filters.count(f) for f in sorted(set(filters))}
    print(f"[{tag} deepsomatic] FILTER column of the somatic VCF: "
          f"{numbers['deepsomatic_filters']} (PON marks PASS records in the "
          "panel of normals)")
    # -- run_pangenome_aware_deepvariant with the GBZ panel --
    g = paths["pangenome"]
    out = os.path.join(directory, "pangenome")
    tally = {}
    seconds = run_pipeline(run_pangenome_aware_deepvariant.main, [
        "--ref", g["ref"], "--reads", g["reads"], "--pangenome", g["panel"],
        "--output_vcf", os.path.join(out, "pangenome.vcf.gz"),
        "--checkpoint", checkpoint, "--batch_size", str(BATCH),
        "--device", device.type,
        "--intermediate_results_dir", os.path.join(out, "work")],
        f"{tag} pangenome", tally, card)
    numbers["pangenome"] = dict(tally, seconds=seconds)
    routes["pangenome"] = dict(
        examples=os.path.join(out, "work",
                              "make_examples_pangenome.tfrecord.gz"),
        cvos=os.path.join(out, "work", "cvo_pangenome.tfrecord.gz"),
        vcf=os.path.join(out, "pangenome.vcf.gz"), sample="default",
        ref=g["ref"], extra=[], height=200)

    # -- every VCF: stage 3 on its CVOs, then float32 beside bfloat16 --
    for name, d in routes.items():
        info = example_codec.read_example_info(d["examples"])
        want = d["height"]
        if list(info["shape"]) != [want, 221, MULTISAMPLE_CHANNELS]:
            raise AssertionError(f"{tag} {name}: examples of shape "
                                 f"{info['shape']}, not {want}x221x7")
        cvos = list(read_cvos(d["cvos"]))
        probs = np.array([c.genotype_probabilities for c in cvos])
        if not len(cvos) or not np.isfinite(probs).all():
            raise AssertionError(f"{tag} {name}: {len(cvos)} CVOs, finite "
                                 f"{np.isfinite(probs).all()}")
        options = {}
        if "--process_somatic" in d["extra"]:
            options = {"process_somatic": True, "pon_vcf_path": (
                d["extra"][-1] if "--pon_filtering" in d["extra"] else None)}
        check_vcf(d["vcf"], cvos, d["ref"], d["sample"], f"{tag} {name}",
                  card, **options)
        pp_argv = ["--ref", d["ref"], "--infile", d["cvos"], "--outfile",
                   d["vcf"], "--sample_name", d["sample"], *d["extra"]]
        numbers[name + "_f32"] = float32_beside(
            d["examples"], d["cvos"], d["vcf"], pp_argv, checkpoint, device,
            f"{tag} {name}")

    # -- the CLI's trio at 100/100/100 rows: 300x221x7 --
    ctag = tag + " cli trio"
    cli_examples = os.path.join(directory, "cli", "trio.tfrecord.gz")
    os.makedirs(os.path.dirname(cli_examples))
    start = time.time()
    quiet(multisample_make_examples.main, [
        "trio", "--ref", f["ref"], "--reads_child", f["child"],
        "--reads_parent1", f["parent1"], "--reads_parent2", f["parent2"],
        "--examples", cli_examples, "--no-realign_reads"], ctag)
    numbers["cli_trio_s"] = time.time() - start
    if list(example_codec.read_example_info(cli_examples)["shape"]) != \
            [300, 221, MULTISAMPLE_CHANNELS]:
        raise AssertionError(f"{ctag}: the CLI's trio is not 300x221x7")

    # -- the CNN at the stacked heights --
    for examples, height_tag in (
            (routes["deeptrio_child"]["examples"], "deeptrio"),
            (routes["deepsomatic"]["examples"], "deepsomatic"),
            (cli_examples, "cli trio")):
        numbers.update(time_stacked_cnn(examples, f"{tag} {height_tag}",
                                        device, card))
    numbers["phase16_s"] = time.time() - phase_start
    print(f"[{tag}] phase 16 {numbers['phase16_s']:.1f} s; {card}")
    return numbers, entry


# -- phase 17: simulate, train, call, score -----------------------------------

def simulate_corpora(directory: str, tag: str) -> dict:
    """The seeded templates, and every corpus of SIM_CORPORA simulated
    from them by the port's simulators. Returns {name: the simulator's
    result, with "ref" the FASTA it was simulated on}."""
    from deepvariant_tpu_torch.testing import synthetic
    from deepvariant_tpu_torch.training import simulate as sim
    from deepvariant_tpu_torch.training import simulate_family as family
    from deepvariant_tpu_torch.training import simulate_longread as longread

    short = write_sample_files(synthetic.synthetic_sample(
        SEED + 17, ((SIM_CONTIG, SIM_TEMPLATE_LENGTH),)),
        os.path.join(directory, "template"), tag + " template")
    long = write_sample_files(synthetic.synthetic_longread_sample(
        SEED + 18, ((SIM_CONTIG, SIM_LONG_TEMPLATE_LENGTH),)),
        os.path.join(directory, "long-template"), tag + " long template")
    simulators = {
        "short": (sim.SimConfig, sim.simulate_corpus, short,
                  SIM_TEMPLATE_LENGTH),
        "long": (longread.LongReadSimConfig,
                 longread.simulate_corpus_longread, long,
                 SIM_LONG_TEMPLATE_LENGTH),
        "trio": (family.TrioSimConfig, family.simulate_trio_corpus, short,
                 SIM_TEMPLATE_LENGTH),
        "somatic": (family.SomaticSimConfig, family.simulate_somatic_corpus,
                    short, SIM_TEMPLATE_LENGTH),
    }
    corpora = {}
    for name, (kind, fields) in SIM_CORPORA.items():
        config_cls, driver, template, length = simulators[kind]
        cfg = config_cls(ref_path=template["ref"], contig=SIM_CONTIG,
                         template_bam=template["reads"],
                         template_region=(SIM_CONTIG, 0, length), **fields)
        start = time.time()
        out = driver(cfg, os.path.join(directory, name))
        seconds = time.time() - start
        counts = {k: v for k, v in out.items() if k.startswith("n_")}
        print(f"[{tag}] simulated {name} ({kind}, seed {fields['seed']}, "
              f"{SIM_CONTIG}:{fields['windows'][0][0]}-"
              f"{fields['windows'][0][1]}): {counts} in {seconds:.2f} s; "
              f"host CPUs {os.cpu_count()}")
        corpora[name] = dict(out, ref=template["ref"], seconds=seconds,
                             counts=counts)
    return corpora


def score(truth: str, vcf: str, bed: str, tag: str, what: str,
          region: str = None) -> dict:
    """The port's vcf_eval of `vcf` against `truth` inside `bed` (and
    `region`): printed, and returned as {tp, fn, fp, f1} of all
    variants."""
    from deepvariant_tpu_torch.tools import vcf_eval

    result = vcf_eval.evaluate(truth, vcf, confident_bed=bed, region=region)
    m = {k: result["all"][k] for k in ("tp", "fn", "fp", "f1")}
    print(f"[{tag}] vcf_eval of {what} against its truth: TP {m['tp']}, "
          f"FN {m['fn']}, FP {m['fp']}, F1 {m['f1']:.4f} (SNP "
          f"{result['snp']['f1']:.4f}, indel {result['indel']['f1']:.4f})")
    return m


def plans_of(options, tag: str, card: str) -> list:
    """The plans of the runner's PlannedExamples of `options`, made in
    this process."""
    kept, _ = run_runner(options, os.path.dirname(options.reads_filename),
                         tag, card, least_plans=1)
    return [p.plan for p in kept]


def phase_simulated(tmp: str, device, card: str):
    """Phase 17: simulate, label, train, call and score on the card.
    Returns (numbers, the kernels-line entry of the plan form on the
    simulated plans, with the launches of the held-out and long-read
    streams)."""
    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
    from deepvariant_tpu_torch.io.tfrecord import TFRecordWriter
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.presets import apply_model_preset
    from deepvariant_tpu_torch.models.checkpoint import (
        load_variables_for_examples,
        save_variables,
    )
    from deepvariant_tpu_torch.ops import pileup_paint as pp
    from deepvariant_tpu_torch.scripts import postprocess_variants as pp_cli
    from deepvariant_tpu_torch.scripts import run_deepsomatic
    from deepvariant_tpu_torch.scripts import run_deepvariant
    from deepvariant_tpu_torch.scripts import run_deeptrio
    from deepvariant_tpu_torch.scripts import run_oracle_inference
    from deepvariant_tpu_torch.scripts import train as train_cli
    from deepvariant_tpu_torch.tools import shuffle_tfrecords

    phase_start = time.time()
    tag = "sim"
    directory = os.path.join(tmp, "simulated")
    numbers = {}

    # -- A: simulate --
    corpora = simulate_corpora(directory, tag + " A")
    numbers["simulate"] = {name: dict(c["counts"], seconds=c["seconds"])
                           for name, c in corpora.items()}
    held = corpora["heldout"]
    ref = held["ref"]

    # -- B: the oracle's ceiling on the held-out corpus --
    btag = tag + " B"
    oracle_vcf = os.path.join(directory, "oracle.vcf.gz")
    start = time.time()
    quiet(run_oracle_inference.main, [
        "--model_type", "WGS", "--ref", ref, "--reads", held["bam"],
        "--output_vcf", oracle_vcf, "--truth_variants", held["truth_vcf"],
        "--confident_regions", held["confident_bed"], "--num_shards",
        str(SIM_SHARDS), "--intermediate_results_dir",
        os.path.join(directory, "oracle")], btag)
    numbers["oracle_s"] = time.time() - start
    numbers["oracle"] = score(
        held["truth_vcf"], oracle_vcf, held["confident_bed"], btag,
        f"run_oracle_inference ({numbers['oracle_s']:.1f} s)")
    if numbers["oracle"]["f1"] < SIM_ORACLE_MIN_F1:
        raise AssertionError(
            f"{btag}: the oracle's F1 {numbers['oracle']['f1']:.4f} is below "
            f"{SIM_ORACLE_MIN_F1}: the simulator, the labeler or vcf_eval is "
            "wrong")

    # -- C: label the training corpus, shuffle, train on the card --
    ctag = tag + " C"
    train = corpora["train"]
    labeled = os.path.join(directory, "labeled",
                           f"train@{SIM_SHARDS}.tfrecord.gz")
    os.makedirs(os.path.dirname(labeled))
    me_argv = ["--mode", "training", "--model_preset", "WGS", "--ref", ref,
               "--reads", train["bam"], "--examples", labeled,
               "--truth_variants", train["truth_vcf"],
               "--confident_regions", train["confident_bed"],
               "--num_shards", str(SIM_SHARDS)]
    start = time.time()
    # The shards in spawned processes, as run_deepvariant runs them.
    with multiprocessing.get_context("spawn").Pool(SIM_SHARDS) as pool:
        for rc, text in pool.map(run_deepvariant._run_make_examples_shard,
                                 [(me_argv, task)
                                  for task in range(SIM_SHARDS)]):
            for line in text.strip().splitlines():
                print(f"[{ctag}] {line}")
            if rc != 0:
                raise AssertionError(f"{ctag}: a make_examples shard "
                                     f"exited {rc}")
    numbers["label_s"] = time.time() - start
    shuffled = os.path.join(directory, "shuffled", "train@2.tfrecord.gz")
    dataset = os.path.join(directory, "shuffled", "train.pbtxt")
    os.makedirs(os.path.dirname(shuffled))
    start = time.time()
    quiet(shuffle_tfrecords.main, [
        "--input_pattern_list", labeled, "--output_pattern", shuffled,
        "--output_dataset_config_pbtxt", dataset,
        "--output_dataset_name", "simulated"], ctag)
    numbers["shuffle_s"] = time.time() - start
    # shuffle_tfrecords writes no example_info.json: the trainer reads
    # the shape and channels of the labeled examples beside the shards.
    shutil.copy(glob_sharded_inputs(labeled)[0] + ".example_info.json",
                glob_sharded_inputs(shuffled)[0] + ".example_info.json")
    n_examples = len(example_records(shuffled))
    exp = os.path.join(directory, "train")
    buf = io.StringIO()
    start = time.time()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main([
            "--config", "wgs_test", "--train_dataset_config", dataset,
            "--tune_dataset_config", dataset, "--experiment_dir", exp,
            "--batch_size", str(SIM_TRAIN_BATCH), "--num_epochs", "1",
            "--device", device.type])
    train_s = time.time() - start
    epochs = [json.loads(line.split(": ", 1)[1])
              for line in buf.getvalue().splitlines()
              if line.startswith("epoch ")]
    if rc != 0 or len(epochs) != 1 or \
            not math.isfinite(epochs[0]["train/loss"]):
        raise AssertionError(f"{ctag}: the train CLI exited {rc} with "
                             f"{epochs}")
    steps = min(n_examples // SIM_TRAIN_BATCH, 50)
    step_ms = SIM_TRAIN_BATCH * 1000.0 / epochs[0]["train/examples_per_sec"]
    numbers.update(labeled_examples=n_examples, train_s=train_s,
                   train_steps=steps, train_ms_per_step=step_ms,
                   train_loss=epochs[0]["train/loss"])
    print(f"[{ctag}] make_examples --mode training {numbers['label_s']:.1f} s"
          f" ({n_examples} labeled examples), shuffle_tfrecords "
          f"{numbers['shuffle_s']:.2f} s, train CLI (wgs_test, full-width "
          f"InceptionV3(7), batch {SIM_TRAIN_BATCH}, {steps} steps) "
          f"{train_s:.1f} s: {step_ms:.1f} ms per step over the epoch "
          f"(its first step included), loss {epochs[0]['train/loss']:.4f}; "
          f"{card}")
    checkpoint = os.path.join(exp, "checkpoints")

    # -- D: call the held-out corpus with C's checkpoint, and score --
    dtag = tag + " D"
    out = os.path.join(directory, "call")
    seen, restore = record_stream_cvos()
    pp.paint_pileup.launches = 0
    try:
        text, stream_s, _ = run_deepvariant_cli([
            "--ref", ref, "--reads", held["bam"], "--output_vcf",
            os.path.join(out, "stream.vcf.gz"), "--checkpoint", checkpoint,
            "--batch_size", str(BATCH), "--num_shards", str(SIM_SHARDS),
            "--intermediate_results_dir", os.path.join(out, "work"),
            "--stream", "--device", device.type], dtag, card)
    finally:
        restore()
    launches = pp.paint_pileup.launches
    (cvos, _), = seen
    if "encoder=device" not in text or launches < 1:
        raise AssertionError(f"{dtag}: the stream launched the plan form "
                             f"{launches} times ({text.strip()[-200:]})")
    # The CVOs through the postprocess CLI with the stats report.
    cvo_path = os.path.join(out, "cvo.tfrecord.gz")
    with TFRecordWriter(cvo_path) as writer:
        for cvo in cvos:
            writer.write(cvo.encode())
    vcf = os.path.join(out, "calls.vcf.gz")
    start = time.time()
    quiet(pp_cli.main, ["--ref", ref, "--infile", cvo_path, "--outfile", vcf,
                        "--vcf_stats_report"], dtag)
    postprocess_s = time.time() - start
    check_vcf(vcf, cvos, ref, pp_cli._sample_name_from_cvos(cvo_path), dtag,
              card)
    if vcf_records(vcf) != vcf_records(os.path.join(out, "stream.vcf.gz")):
        raise AssertionError(f"{dtag}: the CLI's VCF differs from the "
                             "stream's")
    with open(os.path.join(out, "calls.stats.json")) as f:
        stats = json.load(f)
    report = os.path.getsize(os.path.join(out, "calls.visual_report.html"))
    if stats["record_count"] != len(vcf_records(vcf)):
        raise AssertionError(f"{dtag}: the stats count "
                             f"{stats['record_count']} records")
    print(f"[{dtag}] postprocess_variants --vcf_stats_report "
          f"{postprocess_s:.2f} s: {stats['record_count']} records, a "
          f"{report}-byte HTML report")
    numbers["called"] = score(held["truth_vcf"], vcf, held["confident_bed"],
                              dtag, f"the trained model ({steps} steps)")
    numbers.update(call_stream_s=stream_s, call_cvos=len(cvos),
                   call_launches=launches, postprocess_report_s=postprocess_s)
    # The plan form on the held-out corpus's plans, bit for bit: those of
    # the window's first SIM_PLAN_SPAN bases, from the runner in this
    # process with the stream's options.
    lo = SIM_CORPORA["heldout"][1]["windows"][0][0]
    options = apply_model_preset(MakeExamplesOptions(
        reads_filename=held["bam"], ref_filename=ref,
        regions=[f"{SIM_CONTIG}:{lo}-{lo + SIM_PLAN_SPAN}"]), "WGS")
    plans = plans_of(options, dtag, card)
    model, _ = load_variables_for_examples(checkpoint, labeled, device=device)
    predictor = PlanPredictor(model, options.pileup_options,
                              batch_size=BATCH, device=device)
    entry = from_files_entry("pileup_paint_plan_simulated", predictor, plans,
                             dtag, card)
    del predictor, model

    # -- E: the long-read corpus, the trio and the pair through their
    # drivers --
    etag = tag + " E"
    long = corpora["long"]
    long_ckpt = os.path.join(directory, "ckpt-long", "model.msgpack")
    long_model = seeded_model(LONGREAD_SHAPE[2])
    save_variables(long_ckpt, long_model)
    out = os.path.join(directory, "long-call")
    pp.paint_pileup.launches = 0
    text, long_s, _ = run_deepvariant_cli([
        "--model_type", "PACBIO", "--ref", long["ref"], "--reads",
        long["bam"], "--output_vcf", os.path.join(out, "long.vcf.gz"),
        "--checkpoint", long_ckpt, "--batch_size", str(BATCH),
        "--num_shards", str(SIM_SHARDS), "--intermediate_results_dir",
        os.path.join(out, "work"), "--stream", "--device", device.type],
        etag + " long", card)
    long_launches = pp.paint_pileup.launches
    if "encoder=device" not in text or long_launches < 1:
        raise AssertionError(f"{etag}: the long-read stream launched the plan "
                             f"form {long_launches} times")
    lo = SIM_CORPORA["long"][1]["windows"][0][0]
    options = apply_model_preset(MakeExamplesOptions(
        reads_filename=long["bam"], ref_filename=long["ref"],
        regions=[f"{SIM_CONTIG}:{lo}-{lo + SIM_PLAN_SPAN}"]), "PACBIO")
    long_plans = plans_of(options, etag + " long", card)
    from_files_entry("pileup_paint_plan_simulated_longread", PlanPredictor(
        long_model, options.pileup_options, batch_size=BATCH, device=device),
        long_plans, etag + " long", card)
    entry["launches"] = launches + long_launches
    numbers["long"] = dict(score(long["truth_vcf"], os.path.join(
        out, "long.vcf.gz"), long["confident_bed"], etag + " long",
        "the PACBIO stream (seeded weights)"), seconds=long_s,
        launches=long_launches)

    checkpoint7 = os.path.join(directory, "ckpt-7", "model.msgpack")
    save_variables(checkpoint7, seeded_model(MULTISAMPLE_CHANNELS))
    regions = {}
    for name, span in SIM_DRIVER_SPAN.items():
        lo = SIM_CORPORA[name][1]["windows"][0][0]
        regions[name] = f"{SIM_CONTIG}:{lo}-{lo + span}"
    trio = corpora["trio"]
    out = os.path.join(directory, "deeptrio")
    tally = {}
    seconds = run_pipeline(run_deeptrio.main, [
        "--ref", trio["ref"], "--reads_child", trio["bam_child"],
        "--reads_parent1", trio["bam_parent1"], "--reads_parent2",
        trio["bam_parent2"],
        "--output_vcf_child", os.path.join(out, "child.vcf.gz"),
        "--checkpoint_child", checkpoint7, "--checkpoint_parent",
        checkpoint7, "--batch_size", str(BATCH), "--device", device.type,
        "--regions", regions["trio"],
        "--intermediate_results_dir", os.path.join(out, "work")],
        etag + " deeptrio", tally, card)
    numbers["trio"] = dict(score(
        trio["truth_child"], os.path.join(out, "child.vcf.gz"),
        trio["confident_bed"], etag + " deeptrio",
        f"the child's VCF over {regions['trio']} (seeded weights)",
        regions["trio"]), seconds=seconds, stages=tally)
    pair = corpora["pair"]
    out = os.path.join(directory, "deepsomatic")
    tally = {}
    seconds = run_pipeline(run_deepsomatic.main, [
        "--ref", pair["ref"], "--reads_tumor", pair["bam_tumor"],
        "--reads_normal", pair["bam_normal"],
        "--output_vcf", os.path.join(out, "somatic.vcf.gz"),
        "--checkpoint", checkpoint7, "--batch_size", str(BATCH),
        "--device", device.type, "--regions", regions["pair"],
        "--intermediate_results_dir", os.path.join(out, "work")],
        etag + " deepsomatic", tally, card)
    numbers["somatic"] = dict(score(
        pair["truth_somatic"], os.path.join(out, "somatic.vcf.gz"),
        pair["confident_bed"], etag + " deepsomatic",
        f"the somatic VCF over {regions['pair']} (seeded weights)",
        regions["pair"]), seconds=seconds, stages=tally)
    numbers["phase17_s"] = time.time() - phase_start
    print(f"[{tag}] phase 17 {numbers['phase17_s']:.1f} s; the plan form "
          f"launched {launches} + {long_launches} times on the held-out and "
          f"long-read streams; {card}")
    return numbers, entry



# ---------------------------------------------------------------------------
# Phase 18: multi-GPU (torch.distributed) on the one card
# ---------------------------------------------------------------------------

def multi_gpu_weights() -> dict:
    """{params, batch_stats} of the seeded InceptionV3, float32 on the
    CPU: the same in every process."""
    from deepvariant_tpu_torch.training.train import model_variables

    return model_variables(seeded_model(MULTI_GPU_SHAPE[2]), "cpu")


def multi_gpu_batches() -> list:
    rng = np.random.RandomState(SEED + 18)
    n = MULTI_GPU_BATCH
    return [{
        "images": rng.randint(0, 256, (n,) + MULTI_GPU_SHAPE).astype(
            np.uint8),
        "labels": rng.randint(0, 3, n).astype(np.int32),
        "sample_weights": rng.choice([0.5, 1.0, 2.0], n).astype(np.float32),
        "variant_types": rng.randint(0, 3, n).astype(np.int32),
    } for _ in range(MULTI_GPU_STEPS)]


class CollectiveTally:
    """Times every `DataParallel.all_reduce_sum` while active (CUDA events
    on the current stream, the host clock on the CPU), by kind: the flat
    gradient bucket, batch norm's statistics and the micro batches'
    weight sums."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.calls = []

    def kind(self, numel: int) -> str:
        if numel > 100_000:
            return "gradient_bucket"
        return "batch_norm" if numel > MULTI_GPU_ACCUM else "weight_sums"

    @contextlib.contextmanager
    def active(self):
        import torch

        from deepvariant_tpu_torch.parallel.distribute import DataParallel

        original = DataParallel.all_reduce_sum

        def timed(dp, tensor):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = original(dp, tensor)
                end.record()
                self.calls.append((self.kind(tensor.numel()), start, end,
                                   tensor.numel() * tensor.element_size()))
            else:
                t0 = time.perf_counter()
                out = original(dp, tensor)
                self.calls.append((self.kind(tensor.numel()),
                                   time.perf_counter() - t0, None,
                                   tensor.numel() * tensor.element_size()))
            return out

        DataParallel.all_reduce_sum = timed
        try:
            yield self
        finally:
            DataParallel.all_reduce_sum = original

    def summary(self) -> dict:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for kind, start, end, nbytes in self.calls:
            seconds = start.elapsed_time(end) / 1e3 if self.cuda else start
            entry = out.setdefault(kind, {"calls": 0, "s": 0.0, "bytes": 0})
            entry["calls"] += 1
            entry["s"] += seconds
            entry["bytes"] = max(entry["bytes"], nbytes)
        return out


def data_parallel_steps(weights: dict, batches: list, dtype, device,
                        mesh=None) -> dict:
    """MULTI_GPU_STEPS SGD steps with EMA and accumulation of InceptionV3
    (dropout 0) from `weights` in `dtype` (the head in float32), on each
    global batch: data-parallel over `mesh` (this rank's rows), or the
    one-device step without it. Returns the final state (flax layout),
    the losses, each step's milliseconds, and the state after the first
    step."""
    import torch

    from deepvariant_tpu_torch.models.checkpoint import state_to_flax
    from deepvariant_tpu_torch.models.inception_v3 import InceptionV3
    from deepvariant_tpu_torch.training import train as train_lib
    from deepvariant_tpu_torch.training.config import TrainConfig

    cfg = TrainConfig(optimizer="sgd", use_mixed_precision=False,
                      learning_rate=0.001, use_ema=True, ema_momentum=0.9,
                      gradient_accumulation_steps=MULTI_GPU_ACCUM)
    model = InceptionV3(MULTI_GPU_SHAPE[2], dropout_rate=0.0, dtype=dtype)
    tx, _ = train_lib.make_optimizer(cfg, 10)
    variables = {c: {k: v.to(device, torch.float32 if k.startswith(
        "classification") else dtype) for k, v in tree.items()}
        for c, tree in weights.items()}
    state = train_lib.init_state(model, variables, tx)
    step = train_lib.make_train_step(model, tx, cfg, mesh)
    losses, times, first = [], [], None
    for batch in batches:
        if mesh is not None:
            batch = mesh.local_batch(batch, MULTI_GPU_ACCUM)
        tensors = {k: torch.from_numpy(v).to(device)
                   for k, v in batch.items()}
        if device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, loss, _ = step(state, tensors)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            state, loss, _ = step(state, tensors)
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if first is None:
            first = state_to_flax(state)
    return {"state": state_to_flax(state), "first": first,
            "losses": losses, "ms": times}


def state_digest(tree: dict) -> str:
    import hashlib

    digest = hashlib.sha256()
    for key, value in sorted(flat_tree(tree).items()):
        digest.update(repr(key).encode())
        digest.update(np.ascontiguousarray(value).tobytes())
    return digest.hexdigest()


def check_float64_runs(run: dict, reference: dict, start: dict,
                       what: str) -> dict:
    """A float64 data-parallel run against the one-device float64 run:
    after the first step, the update distances, the batch-norm
    statistics and the loss within the limits of MULTI_GPU_F64_*; after
    the last, the distances, returned and not held. Returns the
    distances and the statistics' worst difference relative to its
    leaf's largest value."""
    origin = flat_tree(start)
    out = {}
    for when in ("first", "state"):
        got, want = flat_tree(run[when]), flat_tree(reference[when])
        if set(got) != set(want):
            raise AssertionError(f"{what}: the state trees differ")
        for group in TRAIN_CHECK_GROUPS["sgd"]:
            d = update_distance(got, want, origin, group)
            out[f"{when}/" + "/".join(group)] = d
            if when == "first" and not d <= MULTI_GPU_F64_DISTANCE:
                raise AssertionError(f"{what}: the {group} update is "
                                     f"{d:.3g} from the one-device step's "
                                     f"({out})")
        worst = 0.0
        for key in want:
            if key[0] == "batch_stats":
                scale = float(np.max(np.abs(want[key])))
                worst = max(worst, float(np.max(np.abs(
                    got[key].astype(np.float64) - want[key]))) / scale)
        out[f"{when}/batch_stats"] = worst
        if when == "first" and not worst <= MULTI_GPU_F64_STATS_RTOL:
            raise AssertionError(f"{what}: batch statistics {worst:.3g} "
                                 "apart")
    a, b = run["losses"][0], reference["losses"][0]
    if abs(a - b) > MULTI_GPU_F64_LOSS_RTOL * abs(b):
        raise AssertionError(f"{what}: loss {a} against {b}")
    return out


def check_against_float64(run: dict, reference: dict, start: dict,
                          what: str) -> dict:
    """A float32 run's first loss within MULTI_GPU_LOSS_RTOL of the
    float64 one-device run's, and its first step's update within
    MULTI_GPU_F32_DISTANCE; returns the update distances after the first
    step and after the last."""
    origin = flat_tree(start)
    out = {}
    for when in ("first", "state"):
        got, want = flat_tree(run[when]), flat_tree(reference[when])
        for group in TRAIN_CHECK_GROUPS["sgd"]:
            d = update_distance(got, want, origin, group)
            out[f"{when}/" + "/".join(group)] = d
            if when == "first" and not d <= MULTI_GPU_F32_DISTANCE:
                raise AssertionError(f"{what}: the {group} update is "
                                     f"{d:.4f} from the float64 step's "
                                     f"({out})")
    a, b = run["losses"][0], reference["losses"][0]
    if abs(a - b) > MULTI_GPU_LOSS_RTOL * abs(b):
        raise AssertionError(f"{what}: loss {a} against float64 {b}")
    return out


def multi_gpu_rank(rank: str, store: str, out: str, device: str) -> None:
    """One of phase 18 (B)'s two processes: joins the gloo group at
    `store`, runs the float64 and float32 data-parallel steps on its rows
    of the global batches on `device`, and pickles the losses, step
    milliseconds, collective times and a digest of the final states
    (rank 0 also the float64 and float32 states themselves)."""
    import pickle

    import torch

    from deepvariant_tpu_torch.device import full_float32_precision
    from deepvariant_tpu_torch.parallel import distribute

    rank = int(rank)
    full_float32_precision()
    distribute.initialize_multihost(store, 2, rank, device=device,
                                    timeout_s=MULTI_GPU_RANK_TIMEOUT_S)
    try:
        mesh = distribute.data_parallel_mesh(device)
        weights, batches = multi_gpu_weights(), multi_gpu_batches()
        result = {"backend": mesh.backend, "device": str(mesh.device)}
        for name, dtype in (("f64", torch.float64),
                            ("f32", torch.float32)):
            tally = CollectiveTally(mesh.device)
            with tally.active():
                run = data_parallel_steps(weights, batches, dtype,
                                          mesh.device, mesh)
            run["collectives"] = tally.summary()
            run["digest"] = state_digest(run["state"])
            if rank != 0:
                del run["state"], run["first"]
            result[name] = run
    finally:
        distribute.shutdown()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_processes(argvs, tag: str, timeout: float) -> list:
    """Start one process per argv from the repository root, all at once;
    returns each one's standard output. A failed or hung process fails
    the phase (the others are killed)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(argv, cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    outs = []
    try:
        for i, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise AssertionError(f"{tag}: process {i} exited "
                                     f"{proc.returncode}:\n{err[-4000:]}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


@contextlib.contextmanager
def torchrun_environment(world_rank_port):
    """The variables torchrun sets for a rank, for the block's time."""
    rank, world, port = world_rank_port
    names = {"RANK": rank, "WORLD_SIZE": world, "LOCAL_RANK": rank,
             "LOCAL_WORLD_SIZE": world, "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": port}
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update({k: str(v) for k, v in names.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multihost_pair(directory: str, options: dict, device, tag: str,
                   extra=()) -> tuple:
    """`python -m deepvariant_tpu_torch.parallel.multihost` in two
    processes on `device` (gloo through a file store); returns (the two
    results by rank, seconds)."""
    os.makedirs(directory)
    argvs = [[sys.executable, "-m",
              "deepvariant_tpu_torch.parallel.multihost",
              "--workdir", directory,
              "--coordinator", f"file://{directory}/store",
              "--num_processes", "2", "--process_id", str(pid),
              "--options_json", json.dumps(options),
              "--regions_json", json.dumps(list(MULTI_GPU_REGIONS)),
              "--sample_name", "HG002", "--device", device.type,
              "--timeout_s", str(MULTI_GPU_RANK_TIMEOUT_S), *extra]
             for pid in range(2)]
    start = time.time()
    outs = run_processes(argvs, tag, MULTI_GPU_RANK_TIMEOUT_S)
    seconds = time.time() - start
    by_rank = {}
    for out in outs:
        result = json.loads(out.strip().splitlines()[-1])
        by_rank[result["process_id"]] = result
    if by_rank[0]["all_counts"] != by_rank[1]["all_counts"] or \
            by_rank[0]["all_counts"] != [by_rank[0]["local_examples"],
                                         by_rank[1]["local_examples"]] or \
            min(by_rank[0]["all_counts"]) <= 0:
        raise AssertionError(f"{tag}: gathered counts {by_rank}")
    return by_rank, seconds


def sorted_cvos(paths) -> list:
    from deepvariant_tpu_torch.calling.call_variants import read_cvos

    cvos = [c for p in paths for c in read_cvos(p)]
    return sorted(cvos, key=lambda c: (c.variant.reference_name,
                                       c.variant.start, c.variant.end,
                                       tuple(c.alt_allele_indices)))


def phase_multi_gpu(tmp: str, device, card: str, paint_entry: dict):
    """Phase 18: torch.distributed on the one card. (A) NCCL at world size
    1 from torchrun's variables: all_gather_counts, then the data-parallel
    train step against the one-device step, float64 and float32; (B) two
    processes on the card over gloo, the same steps on the same global
    batches; (C) the multihost pipeline in two processes against one, with
    the toy classifier and with the CNN; (D) the prefetch iterator,
    fused_encode_infer and a Predictor with two replicas on the card
    against the one-device Predictor. The paint kernel must not be
    launched in (A)-(D); its entry on the kernels line says so. (E) the
    PlanPredictor with two replicas against one (its launches are a
    comparison's, not counted). Returns (numbers, the kernels entry)."""
    import pickle

    import torch
    import torch.distributed as dist

    from deepvariant_tpu_torch.calling.call_variants import (ExampleRecord,
                                                             Predictor)
    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.io.bgzf import BgzfReader
    from deepvariant_tpu_torch.make_examples.pileup import (PileupOptions,
                                                            WGS_CHANNELS)
    from deepvariant_tpu_torch.models.checkpoint import save_variables
    from deepvariant_tpu_torch.models.inception_v3 import tree_to_flax
    from deepvariant_tpu_torch.ops import pileup_paint as pp
    from deepvariant_tpu_torch.parallel import distribute, multihost
    from deepvariant_tpu_torch.testing import synthetic

    tag = "multi-gpu"
    phase_start = time.time()
    directory = os.path.join(tmp, tag)
    os.makedirs(directory)
    numbers = {}
    pp.paint_pileup.launches = 0
    weights, batches = multi_gpu_weights(), multi_gpu_batches()

    # -- (A) NCCL at world size 1, from torchrun's variables --
    with torchrun_environment((0, 1, free_port())):
        rank_world = distribute.initialize_multihost(device=device,
                                                     timeout_s=300)
        try:
            mesh = distribute.data_parallel_mesh(device)
            backend = dist.get_backend()
            if rank_world != (0, 1) or (device.type == "cuda" and
                                        backend != "nccl"):
                raise AssertionError(f"{tag}: {rank_world} over {backend}")
            counts = distribute.all_gather_counts(7, mesh)
            if counts.tolist() != [7]:
                raise AssertionError(f"{tag}: all_gather_counts {counts}")
            runs, tallies = {}, {}
            for name, dtype in (("f64", torch.float64),
                                ("f32", torch.float32)):
                runs[f"one_{name}"] = data_parallel_steps(
                    weights, batches, dtype, mesh.device)
                tally = CollectiveTally(mesh.device)
                with tally.active():
                    runs[f"dp_{name}"] = data_parallel_steps(
                        weights, batches, dtype, mesh.device, mesh)
                tallies[name] = tally.summary()
        finally:
            distribute.shutdown()
    start = {"params": tree_to_flax(weights["params"])}
    reference = runs["one_f64"]
    f64 = check_float64_runs(runs["dp_f64"], reference, start,
                             f"{tag} (A) float64")
    distances = {
        "one_f32": check_against_float64(runs["one_f32"], reference, start,
                                         f"{tag} one-device float32"),
        "dp_f32": check_against_float64(runs["dp_f32"], reference, start,
                                        f"{tag} (A) float32"),
    }
    numbers["A"] = {
        "backend": backend, "all_gather_counts": counts.tolist(),
        "f64_against_one_device": f64,
        "f32_update_distance_to_f64": distances,
        "losses": {k: v["losses"] for k, v in runs.items()},
        "ms_per_step": {k: v["ms"] for k, v in runs.items()},
        "collectives": tallies,
    }
    print(f"[{tag}] (A) {backend} world 1: counts {counts.tolist()}; "
          f"float64 data-parallel against the one-device step {f64}; "
          f"float32 update distances to float64 "
          f"{distances}; ms per step " + json.dumps(
              {k: [round(t, 2) for t in v["ms"]] for k, v in runs.items()})
          + f"; collectives {json.dumps(tallies)}; {card}")

    # -- (B) two processes on the card over gloo --
    out = [os.path.join(directory, f"rank{r}.pkl") for r in range(2)]
    start_b = time.time()
    run_processes([[sys.executable, "-c",
                    "import sys, chip_smoke; "
                    "chip_smoke.multi_gpu_rank(*sys.argv[1:])",
                    str(r), f"file://{directory}/store-b", out[r],
                    device.type] for r in range(2)],
                  f"{tag} (B)", MULTI_GPU_RANK_TIMEOUT_S)
    seconds_b = time.time() - start_b
    ranks = []
    for path in out:
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
    numbers["B"] = {"s": seconds_b, "backend": ranks[0]["backend"],
                    "devices": [r["device"] for r in ranks]}
    for name in ("f64", "f32"):
        if ranks[0][name]["digest"] != ranks[1][name]["digest"]:
            raise AssertionError(f"{tag} (B): the ranks' {name} states "
                                 "differ")
        got = ranks[0][name]
        if name == "f64":
            numbers["B"]["f64_against_one_device"] = check_float64_runs(
                got, reference, start, f"{tag} (B) float64")
        else:
            numbers["B"]["f32_update_distance_to_f64"] = \
                check_against_float64(got, reference, start,
                                      f"{tag} (B) float32")
        numbers["B"][f"{name}_losses"] = got["losses"]
        numbers["B"][f"{name}_ms_per_step"] = [r[name]["ms"] for r in ranks]
        numbers["B"][f"{name}_collectives"] = [r[name]["collectives"]
                                               for r in ranks]
    del ranks, runs
    print(f"[{tag}] (B) 2 ranks over {numbers['B']['backend']} on "
          f"{numbers['B']['devices']}: {json.dumps(numbers['B'])}; "
          f"{seconds_b:.1f} s; {card}")

    # -- (C) the multihost pipeline, two processes against one --
    sample = synthetic.synthetic_sample(SEED + 18, MULTI_GPU_CONTIGS)
    paths = write_sample_files(sample, os.path.join(directory, "files"),
                               tag)
    options = dict(reads_filename=paths["reads"],
                   ref_filename=paths["ref"], examples_filename="",
                   mode="calling", realigner_enabled=False,
                   write_run_info=False)
    checkpoint = os.path.join(directory, "ckpt")
    save_variables(os.path.join(checkpoint, "model.msgpack"),
                   seeded_model(SHAPE[2]),
                   {"shape": list(SHAPE), "channels": WGS_CHANNELS})
    numbers["C"] = {}
    for route, extra, fields in (
            ("toy", (), {}),
            ("model", ("--use_model", "--checkpoint", checkpoint,
                       "--dtype", "float32", "--batch_size", "64"),
             dict(use_model=True, checkpoint=checkpoint,
                  dtype=torch.float32, batch_size=64))):
        two_dir = os.path.join(directory, f"two-{route}")
        two, two_s = multihost_pair(two_dir, options, device,
                                    f"{tag} (C) {route}", extra)
        one_dir = os.path.join(directory, f"one-{route}")
        os.makedirs(one_dir)
        start_one = time.time()
        one = multihost.run_host(one_dir, options, list(MULTI_GPU_REGIONS),
                                 sample_name="HG002", device=device,
                                 **fields)
        one_s = time.time() - start_one
        if one["all_counts"] != [sum(two[0]["all_counts"])]:
            raise AssertionError(f"{tag} (C) {route}: {one['all_counts']} "
                                 f"against {two[0]['all_counts']}")
        two_vcf = BgzfReader(two[0]["output_vcf"]).read_all()
        one_vcf = BgzfReader(one["output_vcf"]).read_all()
        max_diff = 0.0
        if route == "toy":
            if two_vcf != one_vcf:
                raise AssertionError(f"{tag} (C) toy: the VCFs differ")
        else:
            two_cvos = sorted_cvos([os.path.join(
                two_dir, f"cvo-{i:05d}-of-00002.tfrecord.gz")
                for i in range(2)])
            one_cvos = sorted_cvos([os.path.join(
                one_dir, "cvo-00000-of-00001.tfrecord.gz")])
            if [locus_key(c.variant, c.alt_allele_indices)
                    for c in two_cvos] != [
                    locus_key(c.variant, c.alt_allele_indices)
                    for c in one_cvos]:
                raise AssertionError(f"{tag} (C) model: the loci differ")
            max_diff = max(float(np.max(np.abs(
                np.asarray(a.genotype_probabilities)
                - np.asarray(b.genotype_probabilities))))
                for a, b in zip(two_cvos, one_cvos))
            if max_diff > MULTI_GPU_PROB_ATOL:
                raise AssertionError(f"{tag} (C) model: probabilities "
                                     f"{max_diff} apart")
            if vcf_lines(two_vcf) != vcf_lines(one_vcf):
                raise AssertionError(f"{tag} (C) model: the VCF records "
                                     "differ")
        numbers["C"][route] = {
            "two_process_s": two_s, "one_process_s": one_s,
            "counts": two[0]["all_counts"],
            "vcf_records": len(vcf_lines(two_vcf)),
            "max_prob_diff": max_diff}
    print(f"[{tag}] (C) multihost, 2 processes against 1: "
          f"{json.dumps(numbers['C'])}; {card}")

    # -- (D) prefetch, fused_encode_infer, two replicas on the card --
    model = seeded_model(SHAPE[2])
    rng = np.random.RandomState(SEED + 19)
    images = rng.randint(0, 256, (MULTI_GPU_EXAMPLES,) + SHAPE).astype(
        np.uint8)
    records = [ExampleRecord(image=img, variant=None,
                             alt_allele_indices=[0]) for img in images]
    one = Predictor(model, BATCH, device, torch.float32)
    two = Predictor(model, BATCH, device, torch.float32,
                    devices=[one.device, one.device])
    timed_d = {}
    results = {}
    for name, predictor in (("one", one), ("two", two)):
        start_d = time.time()
        pairs = list(predictor.predict_stream(iter(records)))
        timed_d[f"{name}_replica_s"] = time.time() - start_d
        if [r for r, _ in pairs] != records:
            raise AssertionError(f"{tag} (D): {name} reordered records")
        results[name] = np.stack([p for _, p in pairs])
    replica_diff = float(np.max(np.abs(results["two"] - results["one"])))
    if replica_diff > MULTI_GPU_PROB_ATOL:
        raise AssertionError(f"{tag} (D): two replicas {replica_diff} "
                             "from one")
    full = MULTI_GPU_EXAMPLES - MULTI_GPU_EXAMPLES % BATCH
    fused = np.concatenate(list(distribute.fused_encode_infer(
        (images[i:i + BATCH] for i in range(0, full, BATCH)),
        lambda variables, batch: one.forward(batch), None, device)))
    fused_diff = float(np.max(np.abs(fused - results["one"][:full])))
    if fused_diff > MULTI_GPU_PROB_ATOL:
        raise AssertionError(f"{tag} (D): fused_encode_infer {fused_diff} "
                             "from the Predictor")
    moved = list(distribute.DevicePrefetchIterator(
        ({"i": np.full(4, i, np.int32), "x": images[i, :2]}
         for i in range(6)), device))
    if [int(m["i"][0]) for m in moved] != list(range(6)) or any(
            m["x"].device.type != device.type or not np.array_equal(
                m["x"].cpu().numpy(), images[i, :2])
            for i, m in enumerate(moved)):
        raise AssertionError(f"{tag} (D): the prefetch iterator")
    launches = pp.paint_pileup.launches
    numbers["D"] = {**timed_d, "replica_max_diff": replica_diff,
                    "fused_max_diff": fused_diff,
                    "batch_size": [one.batch_size, two.batch_size]}
    print(f"[{tag}] (D) {json.dumps(numbers['D'])}; paint kernel launches "
          f"in (A)-(D): {launches}; {card}")
    if launches != 0:
        raise AssertionError(f"{tag}: the paint kernel was launched "
                             f"{launches} times")
    del one, two, results

    # -- (E) the plan path with two replicas (a comparison) --
    options_wgs = PileupOptions()
    plans = random_plans(BATCH + 40, SEED + 20)
    want = PlanPredictor(model, options_wgs, batch_size=BATCH, device=device,
                         dtype=torch.float32)
    got = PlanPredictor(model, options_wgs, batch_size=BATCH, device=device,
                        dtype=torch.float32, devices=[want.predictor.device]
                        * 2)
    probs = [np.stack([p for _, p in predictor.predict_plan_stream(
        iter([type("Planned", (), {"plan": p}) for p in plans]))])
        for predictor in (want, got)]
    plan_diff = float(np.max(np.abs(probs[1] - probs[0])))
    if plan_diff > MULTI_GPU_PROB_ATOL:
        raise AssertionError(f"{tag} (E): two replicas {plan_diff} from one")
    numbers["E_plan_replica_max_diff"] = plan_diff
    numbers["phase18_s"] = time.time() - phase_start
    print(f"[{tag}] (E) PlanPredictor, two replicas against one: "
          f"{plan_diff:.3g}; phase 18 {numbers['phase18_s']:.1f} s; {card}")
    entry = {**paint_entry, "name": "pileup_paint_plan_multi_gpu",
             "launches": launches, "expected_launches": 0,
             "path": "phase 18: data-parallel steps, multihost, Predictor "
                     "replicas (host-painted or no pileups, as in JAX)"}
    return numbers, entry


# ---------------------------------------------------------------------------
# Phase 19: the accuracy drivers
# ---------------------------------------------------------------------------

def run_driver(name: str, argv, tag: str):
    """A driver's `main(argv)` in this process; its lines printed under
    `tag` (the epochs' and the JSON ones left out, the rest cut to 200
    characters). Returns (the JSON of its last JSON line or None, its
    seconds)."""
    import importlib

    mod = importlib.import_module(f"deepvariant_tpu_torch.scripts.{name}")
    buf = io.StringIO()
    start = time.time()
    with contextlib.redirect_stdout(buf):
        mod.main(list(argv))
    seconds = time.time() - start
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        if not line.startswith(("{", "epoch ")):
            print(f"[{tag}] {line[:200]}")
    found = [line for line in lines if line.startswith("{")]
    return (json.loads(found[-1]) if found else None), seconds


def f1_of(metrics) -> float:
    """The F1 of all variants of a vcf_eval result, which must lie in
    [0, 1]."""
    f1 = float(metrics["all"]["f1"])
    if not 0.0 <= f1 <= 1.0:
        raise AssertionError(f"an F1 of {f1!r}")
    return f1


def accuracy_plan_entry(sim_dir: str, src: dict, span, device, tag: str,
                        card: str) -> dict:
    """The plan form on accuracy_sim's held-out calling examples of
    `src` over `span`: the runner in this process with the driver's
    options gives the same examples and, beside them, their plans; every
    image the plan form paints equals the driver's, bit for bit. Returns
    the kernels-line entry, its launches those of that painting."""
    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.models.checkpoint import (
        load_variables_for_examples,
    )
    from deepvariant_tpu_torch.ops import pileup_paint as pp

    lo, hi = span
    calling = os.path.join(sim_dir, f"eval_{src['label']}",
                           "calling.tfrecord.gz")
    beside = os.path.join(sim_dir, "beside")
    os.makedirs(beside)
    options = MakeExamplesOptions(
        reads_filename=src["reads"], ref_filename=src["ref"],
        examples_filename=os.path.join(beside, "calling.tfrecord.gz"),
        mode="calling", regions=[f"{src['contig']}:{lo}-{hi}"],
        realigner_enabled=True)
    records, plans, _, _ = examples_beside_plans(options, tag, card)
    if records != example_records(calling):
        raise AssertionError(f"{tag}: the runner's examples differ from the "
                             "driver's")
    ckpt = os.path.join(sim_dir, "experiment", "checkpoints",
                        "final.msgpack")
    model, _ = load_variables_for_examples(ckpt, calling, device=device)
    predictor = PlanPredictor(model, options.pileup_options,
                              batch_size=BATCH, device=device)
    pp.paint_pileup.launches = 0
    check_host_images(predictor, records, plans, tag)
    launches = pp.paint_pileup.launches
    entry = from_files_entry("pileup_paint_plan_accuracy", predictor,
                             [p.plan for p in plans], tag, card)
    entry["launches"] = launches
    print(f"[{tag}] the plan form launched {launches} times painting "
          f"{len(plans)} held-out plans of accuracy_sim; {card}")
    return entry


def phase_accuracy_drivers(tmp: str, device, card: str):
    """Phase 19: the nine accuracy drivers on the card. Returns (numbers,
    the kernels-line entry of the plan form on accuracy_sim's held-out
    plans)."""
    from deepvariant_tpu_torch.ops import pileup_paint as pp
    from deepvariant_tpu_torch.scripts import accuracy_sim
    from deepvariant_tpu_torch.testing import accuracy_inputs
    from deepvariant_tpu_torch.training import train as train_lib

    phase_start = time.time()
    tag = "acc"
    directory = os.path.join(tmp, "accuracy")
    start = time.time()
    inputs = accuracy_inputs.write_inputs(os.path.join(directory, "inputs"))
    constants = accuracy_inputs.driver_constants(inputs)
    numbers = {"inputs_s": time.time() - start}
    print(f"[{tag}] seeded stand-ins (templates, two short-read runs, a "
          f"long-read run, a family) in {numbers['inputs_s']:.2f} s")

    def work(label):
        return os.path.join(directory, label)

    def counts_of(label):
        with open(os.path.join(work(label), "corpus_counts.json")) as f:
            return json.load(f)

    common = ["--num_workers", str(ACC_WORKERS), "--batch_size",
              str(ACC_BATCH), "--num_epochs", "1", "--device", device.type]
    lo, hi = ACC_EVAL_SPAN
    staged = (
        ("sim", "accuracy_sim", ["--seeds", "101", "--coverage", "30",
                                 "--eval_span", f"{lo}-{hi}"]),
        ("longread", "accuracy_longread", ["--family", "pacbio",
                                           "--seeds", "101"]),
        ("trio", "accuracy_trio", ["--seeds", "501"]),
        ("somatic", "accuracy_somatic", ["--seeds", "601"]),
        ("hybrid", "accuracy_hybrid", ["--seeds", "701"]),
    )
    cross = (
        ("chr20", "accuracy_chr20", ["--cross_eval", "--report",
                                     os.path.join(directory, "chr20.md")]),
        ("ont", "accuracy_ont", ["--n_folds", "2"]),
        ("deeptrio", "accuracy_deeptrio", ["--n_folds", "2"]),
    )
    # Each driver's work directory goes when its numbers are taken (the
    # full-width checkpoints are 0.1-0.3 GB each).
    entry, driver_launches = None, 0
    with accuracy_inputs.patched(constants):
        for label, name, flags in staged:
            pp.paint_pileup.launches = 0
            seconds, outs = {}, {}
            for stage in ("gen", "train", "eval"):
                outs[stage], seconds[stage] = run_driver(name, [
                    "--workdir", work(label), "--stages", stage] + common +
                    flags, f"{tag} {label} {stage}")
            out = outs["eval"]
            if label == "longread":
                labeled = outs["gen"]["corpus"]["train"]
                model, oracle = (out["eval"]["model_confident"],
                                 out["eval"]["oracle_confident"])
            else:
                labeled = counts_of(label)["train"]
                model, oracle = out["model"], out.get("oracle")
            numbers[label] = dict(
                stage_s=seconds, labeled_examples=labeled,
                model_f1=f1_of(model),
                oracle_f1=f1_of(oracle) if oracle else None)
            driver_launches += pp.paint_pileup.launches
            if label == "sim":
                entry = accuracy_plan_entry(
                    work(label), constants["accuracy_sim"]["EVAL_SOURCES"][0],
                    ACC_EVAL_SPAN, device, tag, card)
            if label == "somatic":
                somatic_eval = out
            else:
                shutil.rmtree(work(label))
        pp.paint_pileup.launches = 0
        out, seconds = run_driver("resume_somatic_eval", [
            "--workdir", work("somatic"), "--batch_size", str(ACC_BATCH),
            "--device", device.type, "--report",
            os.path.join(directory, "resumed.json")], f"{tag} resume")
        driver_launches += pp.paint_pileup.launches
        if out != somatic_eval:
            raise AssertionError(f"{tag}: resume_somatic_eval's JSON differs "
                                 "from accuracy_somatic's eval")
        numbers["resume_somatic"] = dict(seconds=seconds,
                                         model_f1=f1_of(out["model"]))
        shutil.rmtree(work("somatic"))
        for label, name, flags in cross:
            pp.paint_pileup.launches = 0
            tally = {}
            restore = [wrap(train_lib, "train", tally, "train"),
                       wrap(accuracy_sim, "call_checkpoint", tally, "call")]
            try:
                out, seconds = run_driver(name, [
                    "--workdir", work(label), "--batch_size", str(ACC_BATCH),
                    "--num_epochs", "1", "--device", device.type] + flags,
                    f"{tag} {label}")
            finally:
                for undo in restore:
                    undo()
            if len(out["folds"]) != 2:
                raise AssertionError(f"{tag} {label}: {len(out['folds'])} "
                                     "folds")
            numbers[label] = dict(
                stage_s={"stage1": seconds - tally["train_s"] -
                         tally["call_s"], "train": tally["train_s"],
                         "call": tally["call_s"], "all": seconds},
                labeled_examples=out["train_examples"],
                model_f1=f1_of(out["metrics"]), oracle_f1=None)
            driver_launches += pp.paint_pileup.launches
            shutil.rmtree(work(label))
    entry["driver_launches"] = driver_launches
    if driver_launches:
        raise AssertionError(f"{tag}: the drivers, which paint on the host, "
                             f"launched the plan form {driver_launches} "
                             "times")
    for label, n in numbers.items():
        if not isinstance(n, dict) or "stage_s" not in n:
            continue
        stages = ", ".join(f"{k} {v:.1f} s" for k, v in n["stage_s"].items())
        oracle = (f", oracle F1 {n['oracle_f1']:.4f}"
                  if n["oracle_f1"] is not None else "")
        print(f"[{tag}] {label}: {stages}; {n['labeled_examples']} labeled "
              f"examples; model F1 {n['model_f1']:.4f}{oracle}; {card}")
    if numbers["sim"]["oracle_f1"] < SIM_ORACLE_MIN_F1:
        raise AssertionError(
            f"{tag}: accuracy_sim's oracle F1 {numbers['sim']['oracle_f1']:.4f}"
            f" is below {SIM_ORACLE_MIN_F1}")

    numbers["phase19_s"] = time.time() - phase_start
    print(f"[{tag}] phase 19 {numbers['phase19_s']:.1f} s; the plan form "
          f"launched {entry['launches']} times on accuracy_sim's held-out "
          f"plans, 0 times in the drivers; {card}")
    return numbers, entry


def vcf_lines(text: bytes) -> list:
    return [line for line in text.split(b"\n")
            if line and not line.startswith(b"#")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepvariant_tpu_torch.device import full_float32_precision
    from deepvariant_tpu_torch.ops import pileup_paint as pp

    device = torch.device("cuda")
    full_float32_precision()
    card = nvidia_smi()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    summary = {"build_s": phase_build()}
    kernels = phase_paint_kernel(device)
    wgs_kernel, longread_kernel, stream_kernel = kernels
    bn_kernels = phase_batch_norm_relu(device, card)
    pool_kernels = phase_pool(device, card)
    from deepvariant_tpu_torch.make_examples.pileup import PileupOptions
    from deepvariant_tpu_torch.make_examples.presets import (
        apply_pileup_preset,
    )

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # The WGS paths: the staged CLI, then the fused plan path.
        pp.paint_pileup.launches = 0
        staged, model = phase_staged(tmp, device)
        plan_numbers, predictor, plans, probs = phase_plans(
            model, device, apply_pileup_preset(PileupOptions(), "WGS"),
            "plans")
        wgs_kernel["launches"] = pp.paint_pileup.launches
        check_plan_path(predictor, plans, probs, device, "plans")
        summary.update(time_device_steps(predictor, plans, model, device,
                                         "steps"))
        del predictor, plans, probs
        # Stage 1 from files through the stream path, the WGS model:
        # realigner off, then the preset's defaults.
        stream_numbers, stream_kernel["launches"] = phase_stream(
            tmp, model, device, card)
        summary.update(stream_numbers)
        realign_numbers, realign_kernel = phase_realigned_stream(
            tmp, model, device, card)
        summary.update(realign_numbers)
        kernels.append(realign_kernel)

        # The long-read path: the PACBIO preset at 100x147x10.
        longread_options = apply_pileup_preset(PileupOptions(), "PACBIO")
        longread_model = seeded_model(LONGREAD_SHAPE[2])
        pp.paint_pileup.launches = 0
        longread_numbers, predictor, plans, probs = phase_plans(
            longread_model, device, longread_options, "longread")
        longread_kernel["launches"] = pp.paint_pileup.launches
        check_plan_path(predictor, plans, probs, device, "longread")
        summary.update({
            f"longread_{k}": v for part in (
                longread_numbers, time_device_steps(
                    predictor, plans, longread_model, device,
                    "longread steps"))
            for k, v in part.items()})
        del predictor, plans, probs
        # Long reads from files through the stream path.
        longread_files_numbers, longread_files_kernel = \
            phase_longread_stream(tmp, longread_model, device, card)
        summary.update(longread_files_numbers)
        kernels.append(longread_files_kernel)
        # The allele-frequency model from files to a VCF and a gVCF.
        af_numbers, af_kernel = phase_af_gvcf(
            tmp, seeded_model(AF_SHAPE[2]), device, card)
        summary.update(af_numbers)
        kernels.append(af_kernel)
        # The one-step command, staged and streamed.
        run_dv_numbers, run_dv_kernel, bam_route = phase_run_deepvariant(
            tmp, device, card)
        summary.update(run_dv_numbers)
        kernels.append(run_dv_kernel)
        # The read-side options: normalization and OQ on the kernel's
        # route, methylation, the homopolymer channels, the sweep.
        read_numbers, read_kernel = phase_read_options(tmp, device, card)
        summary.update(read_numbers)
        kernels.append(read_kernel)
        # CRAM input and training mode: phase 11's sample as a CRAM to a
        # VCF, and its labeled plans painted on the card.
        cram_numbers, cram_kernels, labeled = phase_cram_training(
            tmp, device, card, bam_route)
        summary.update(cram_numbers)
        kernels.extend(cram_kernels)
        # Training on the card: phase 13's labeled examples through the
        # train CLI, call_variants and train_resident; one step against
        # the CPU; ms per step at full width.
        training_numbers = phase_training(tmp, device, card, labeled)
        summary.update(training_numbers)
        for e in bn_kernels:
            e["launches"] = \
                training_numbers["train_timing"]["bfloat16_x4"]["bn_launches"]
        for e in pool_kernels:
            e["launches"] = training_numbers["train_timing"][
                "bfloat16_x4"]["pool_launches"]
        # The small model on phase 11's sample (rows, training, the gate
        # on the main path), run_oracle_inference, and the export of phase
        # 14's checkpoint, the Keras import and the stem rewrites.
        small_numbers, small_kernel = phase_small_model(
            tmp, device, card, bam_route, labeled,
            os.path.join(tmp, "training", "cli", "checkpoints"))
        del bam_route
        summary.update(small_numbers)
        kernels.append(small_kernel)
        # Multi-sample make_examples and the DeepTrio, DeepSomatic and
        # pangenome-aware one-step scripts; the trio planes painted by the
        # plan form.
        multisample_numbers, multisample_kernel = phase_multisample(
            tmp, device, card)
        summary["multisample"] = multisample_numbers
        kernels.append(multisample_kernel)
        # Simulate corpora, the oracle's ceiling, label, shuffle and
        # train on one, call and score another, and the long-read, trio
        # and tumour/normal corpora through their drivers.
        simulated_numbers, simulated_kernel = phase_simulated(
            tmp, device, card)
        summary["simulated"] = simulated_numbers
        kernels.append(simulated_kernel)
        # torch.distributed on the one card: NCCL at world size 1, two
        # ranks over gloo, the multihost pipeline, replicas.
        multi_numbers, multi_kernel = phase_multi_gpu(
            tmp, device, card, wgs_kernel)
        summary["multi_gpu"] = multi_numbers
        kernels.append(multi_kernel)
        # The nine accuracy drivers on seeded stand-ins, and the plan
        # form on accuracy_sim's held-out plans.
        accuracy_numbers, accuracy_kernel = phase_accuracy_drivers(
            tmp, device, card)
        summary["accuracy"] = accuracy_numbers
        kernels.append(accuracy_kernel)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_region_encoder(device)
    kernels.extend(bn_kernels)
    kernels.extend(pool_kernels)

    for k in kernels:
        if k.get("expected_launches") == 0:
            if k["launches"] != 0:
                raise AssertionError(f"kernel {k['name']} was launched on "
                                     "a path that paints nothing")
        elif k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} was not launched on "
                                 "its path")
    summary.update(staged)
    summary.update(plan_numbers)
    summary["card"] = card
    print(json.dumps({"smoke": summary}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
