"""tools/ of the PyTorch port against the JAX package's, on simulated
corpora.

One corpus is simulated from the seeded template (20 kb, seed 1), and
a seeded call set is made against its truth (`torch_sim_util.
write_calls`: missed sites, wrong genotypes and alleles, false
positives, RefCall and multi-allelic records, CVOs for some misses).
Every tool is host code in both packages and is held exactly: the
vcf_eval metrics and CLI output, the vcf_stats JSON and HTML,
preprocess_truth's .vcf.gz and .tbi bytes, shuffle_tfrecords' shards
and dataset config (over the port's labeled examples of the corpus),
fn_audit's rows and JSON, print_f1's table, and the HTML of
runtime_by_region_vis (the runtime TSV of the same make_examples run)
and of dashboard. The fixture-free cases of the JAX
`tests/test_tools.py`, `test_truth_tools.py`, `test_fn_audit.py` and
`test_dashboard.py` run once more on the port's modules.
"""

import io
import json
import os

import pytest
import torch

import test_dashboard
import test_fn_audit
import test_tools
import test_truth_tools
from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from torch_multisample_util import port_twin, run_twin_case, twin_cases
from torch_sim_util import (
    JAX,
    PORT,
    file_bytes,
    label_corpus,
    module,
    overlapping_truth,
    simulate,
    write_calls,
    write_templates,
)

torch.set_num_threads(2)

TWINS = {m.__name__: port_twin(m) for m in (
    test_tools, test_truth_tools, test_fn_audit, test_dashboard)}
CASES = [(name, case) for name, twin in sorted(TWINS.items())
         for case in twin_cases(twin, ("tmp_path", "capsys"))]


def test_jax_cases_are_collected():
    ids = [f"{m}::{c[0]}" for m, c in CASES]
    assert len(ids) == len(set(ids)) >= 30


@pytest.mark.parametrize("module_name,case", CASES,
                         ids=[f"{m}::{c[0]}" for m, c in CASES])
def test_jax_case_on_the_port(module_name, case, tmp_path, capsys):
    _id, cls_name, name, params = case
    run_twin_case(TWINS[module_name], cls_name, name, params,
                  tmp_path=tmp_path, capsys=capsys)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    templates = write_templates(root / "templates")
    sim = simulate(PORT, "short", templates, root / "corpus", seed=1,
                   windows=[(5000, 25_000)])
    calls = write_calls(sim["variants"], root / "calls", seed=1)
    labeled = label_corpus(sim, templates["ref"], root / "labeled",
                           "chr20:6000-9000")
    return dict(sim, ref=templates["ref"], **calls, **labeled,
                root=str(root))


def tool(package, name):
    return module(package, f"tools.{name}")


def run_main(package, name, argv, capsys) -> str:
    tool(package, name).main(argv)
    return capsys.readouterr().out


# -- vcf_eval -------------------------------------------------------------------

EVAL_CASES = {
    "confident": dict(confident=True, region=None),
    "no-bed": dict(confident=False, region=None),
    "region": dict(confident=True, region="chr20:9000-18000"),
}


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_vcf_eval_equals_jax(name, corpus, tmp_path, capsys):
    case = EVAL_CASES[name]
    bed = corpus["confident_bed"] if case["confident"] else None
    results = [tool(p, "vcf_eval").evaluate(
        corpus["truth_vcf"], corpus["calls"], confident_bed=bed,
        region=case["region"]) for p in (JAX, PORT)]
    assert results[1] == results[0]
    m = results[1]["all"]
    assert m["tp"] > 10 and m["fn"] > 3 and m["fp"] > 3 and 0 < m["f1"] < 1
    outs = []
    for package in (JAX, PORT):
        metrics = str(tmp_path / f"{package}.metrics")
        argv = ["--truth_vcf", corpus["truth_vcf"], "--query_vcf",
                corpus["calls"], "--metrics_out", metrics]
        if bed:
            argv += ["--confident_regions", bed]
        if case["region"]:
            argv += ["--region", case["region"]]
        outs.append((run_main(package, "vcf_eval", argv, capsys),
                     open(metrics).read()))
    assert outs[1] == outs[0]
    assert json.loads(outs[1][0]) == results[1]


def test_vcf_eval_truth_against_itself(corpus):
    for package in (JAX, PORT):
        result = tool(package, "vcf_eval").evaluate(
            corpus["truth_vcf"], corpus["truth_vcf"],
            corpus["confident_bed"])
        assert result["all"]["f1"] == 1.0
        assert result["all"]["tp"] == corpus["n_variants"]
    assert tool(PORT, "vcf_eval").wilson_ci(7, 9) == \
        tool(JAX, "vcf_eval").wilson_ci(7, 9)


# -- vcf_stats ------------------------------------------------------------------

@pytest.mark.parametrize("vcf", ["calls", "truth_vcf"])
def test_vcf_stats_equals_jax(vcf, corpus, tmp_path, capsys):
    outs = {}
    for package in (JAX, PORT):
        base = str(tmp_path / package / "report")
        os.makedirs(os.path.dirname(base))
        printed = run_main(package, "vcf_stats", [
            "--input_vcf", corpus[vcf], "--outfile_base", base], capsys)
        outs[package] = (printed.replace(base, "<base>"),
                         file_bytes(tmp_path / package))
    assert outs[PORT] == outs[JAX]
    files = outs[PORT][1]
    assert sorted(files) == ["report.stats.json", "report.visual_report.html"]
    stats = json.loads(files["report.stats.json"])
    assert stats["record_count"] > 10
    assert b"<svg" in files["report.visual_report.html"]


# -- preprocess_truth -----------------------------------------------------------

@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("source", ["overlapping", "simulated"])
def test_preprocess_truth_equals_jax(source, suffix, corpus, tmp_path):
    if source == "overlapping":
        truth = str(tmp_path / "overlapping.vcf")
        groups = overlapping_truth(corpus["variants"], truth)
        assert groups > 0
    else:
        truth = corpus["truth_vcf"]
    outs = {}
    for package in (JAX, PORT):
        os.makedirs(tmp_path / package)
        stats = tool(package, "preprocess_truth").preprocess_truth(
            truth, str(tmp_path / package / f"out{suffix}"))
        outs[package] = (stats, file_bytes(tmp_path / package))
    assert outs[PORT] == outs[JAX]
    stats, files = outs[PORT]
    if source == "overlapping":
        assert stats["groups_collapsed"] == groups
    assert sorted(files) == ([f"out{suffix}", f"out{suffix}.tbi"]
                             if suffix.endswith(".gz") else [f"out{suffix}"])


# -- shuffle_tfrecords ----------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 3])
def test_shuffle_tfrecords_equals_jax(shards, corpus, tmp_path, monkeypatch,
                                      capsys):
    """Relative output names, so that the dataset configs name the same
    path in both packages' directories."""
    from deepvariant_tpu_torch.io.tfrecord import TFRecordReader

    spec = "shuffled.tfrecord" if shards == 1 else \
        f"shuffled@{shards}.tfrecord"
    outs = {}
    for package in (JAX, PORT):
        os.makedirs(tmp_path / package)
        monkeypatch.chdir(tmp_path / package)
        printed = run_main(package, "shuffle_tfrecords", [
            "--input_pattern_list", corpus["examples"], "--output_pattern",
            spec, "--output_dataset_config_pbtxt", "ds.pbtxt",
            "--output_dataset_name", "sim"], capsys)
        outs[package] = (printed, file_bytes(tmp_path / package))
    assert outs[PORT] == outs[JAX]
    records = [r for p in glob_sharded_inputs(corpus["examples"])
               for r in TFRecordReader(p)]
    shuffled = [r for p in sorted(outs[PORT][1]) if p != "ds.pbtxt"
                for r in TFRecordReader(str(tmp_path / PORT / p))]
    assert len(records) > 10 and sorted(shuffled) == sorted(records)
    assert shuffled != records
    assert f"num_examples: {len(records)}" in \
        outs[PORT][1]["ds.pbtxt"].decode()


# -- fn_audit and print_f1 ------------------------------------------------------

def test_fn_audit_equals_jax(corpus, tmp_path, capsys):
    rows = [tool(p, "fn_audit").run(
        corpus["truth_vcf"], corpus["calls"], corpus["cvos"],
        confident_bed=corpus["confident_bed"]) for p in (JAX, PORT)]
    assert rows[1] == rows[0]
    assert {r["category"] for r in rows[1]} == {
        "wrong_genotype", "wrong_allele", "cnn_ref_call", "cnn_low_qual",
        "no_candidate"}
    outs = []
    for package in (JAX, PORT):
        path = str(tmp_path / f"{package}.json")
        printed = run_main(package, "fn_audit", [
            "--truth", corpus["truth_vcf"], "--query", corpus["calls"],
            "--cvos", corpus["cvos"], "--confident_bed",
            corpus["confident_bed"], "--region", "chr20:5000-15000",
            "--out", path], capsys)
        outs.append((printed, open(path).read()))
    assert outs[1] == outs[0]
    assert 0 < len(json.loads(outs[1][1])) < len(rows[1])


def test_print_f1_equals_jax(corpus, tmp_path, capsys):
    """Three checkpoints' call sets scored by vcf_eval --metrics_out, then
    the table."""
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    for epoch, seed in ((2, 3), (11, 4), (5, 5)):
        calls = write_calls(corpus["variants"][epoch:], tmp_path / str(seed),
                            seed=seed)
        run_main(PORT, "vcf_eval", [
            "--truth_vcf", corpus["truth_vcf"], "--query_vcf",
            calls["calls"], "--metrics_out",
            str(metrics / f"ckpt-{epoch}.metrics")], capsys)
    tables = [run_main(p, "print_f1", ["--metrics_dir", str(metrics)],
                       capsys) for p in (JAX, PORT)]
    assert tables[1] == tables[0]
    assert [line.split("\t")[0] for line in tables[1].splitlines()] == \
        ["2", "5", "11"]


# -- runtime_by_region_vis and dashboard ----------------------------------------

def test_runtime_by_region_vis_equals_jax(corpus, tmp_path, capsys):
    columns, rows = tool(PORT, "runtime_by_region_vis").read_runtime_tsv(
        corpus["runtime"])
    assert (columns, rows) == tool(
        JAX, "runtime_by_region_vis").read_runtime_tsv(corpus["runtime"])
    assert rows and "make pileup images" in columns
    pages = []
    for package in (JAX, PORT):
        out = str(tmp_path / "runtime.html")
        printed = run_main(package, "runtime_by_region_vis", [
            "--input", corpus["runtime"], "--title", "sim", "--output", out],
            capsys)
        pages.append((printed, open(out).read()))
    assert pages[1] == pages[0]
    assert rows[0]["region"] in pages[1][1]


@pytest.mark.parametrize("separate,outline", [(False, False), (True, True)])
def test_dashboard_equals_jax(separate, outline, corpus):
    result = tool(PORT, "vcf_eval").evaluate(
        corpus["truth_vcf"], corpus["calls"], corpus["confident_bed"])
    kinds = ["snp", "indel", "all"]
    pages = []
    for package in (JAX, PORT):
        d = tool(package, "dashboard")
        specs = [
            {"id": "f1", "chart": d.BarChart(
                kinds, [result[k]["f1"] for k in kinds], title="F1")},
            {"id": "curve", "chart": d.LineChart(
                [0, 1, 2], [result[k]["recall"] for k in kinds],
                title="recall <by type>")},
            {"id": "table", "chart": d.Table(
                ["type", "tp", "fn", "fp"],
                [[k] + [result[k][m] for m in ("tp", "fn", "fp")]
                 for k in kinds], title="counts & more")},
            {"id": "note", "html": "<p>simulated corpus</p>"},
        ]
        buf = io.StringIO()
        d.create_html_report(specs, buf, title="vcf_eval", subtitle="sim",
                             charts_on_separate_lines=separate,
                             include_outline=outline)
        pages.append(buf.getvalue())
    assert pages[1] == pages[0]
    assert "counts &amp; more" in pages[1]
