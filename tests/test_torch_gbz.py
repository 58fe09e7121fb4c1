"""The port's GBZ container (deepvariant_tpu_torch/io/gbz.py) and
sequence utilities (core/sequence_utils.py) against the JAX package's.

Host code, held byte for byte: the GBZ file each package's `write_gbz`
makes of the same graph, the paths and metadata each `read_gbz` decodes
from the other's file, `haplotype_reads` over graphs with SNP,
insertion, deletion and reverse-oriented nodes, and the panel BAM and
its .bai of `extract_panel_bam`. The graphs: the bubble graph and the
reverse-orientation graph of tests/test_gbz.py, and the seeded 16-
haplotype panels of `synthetic.synthetic_pangenome` (one and two
contigs, every fourth allele node and every seventh reference stretch
walked in reverse). The hand-built format vectors of
tests/test_gbz_spec_vectors.py and the alphabet tables of
tests/test_sequence_utils_port.py run once more on the port (those
files are read, not edited).
"""

import os

import pytest
import torch

import test_gbz_spec_vectors
import test_sequence_utils_port
from deepvariant_tpu.core import sequence_utils as jsu
from deepvariant_tpu.core.types import Range as JRange
from deepvariant_tpu.io import gbz as jgbz
from deepvariant_tpu_torch.core import sequence_utils as tsu
from deepvariant_tpu_torch.core.types import Range as TRange
from deepvariant_tpu_torch.io import gbz as tgbz
from deepvariant_tpu_torch.testing import synthetic
from torch_multisample_util import (
    port_twin,
    read_bytes,
    run_twin_case,
    twin_cases,
)
from torch_port_util import assert_reads_equal

torch.set_num_threads(2)

TWINS = {m.__name__: port_twin(m)
         for m in (test_gbz_spec_vectors, test_sequence_utils_port)}
CASES = [(name, case) for name, twin in sorted(TWINS.items())
         for case in twin_cases(twin)]


def test_jax_cases_are_collected():
    ids = [f"{m}::{c[0]}" for m, c in CASES]
    assert len(ids) == len(set(ids))
    assert sum(m == "test_gbz_spec_vectors" for m, _ in CASES) == 10
    assert sum(m == "test_sequence_utils_port" for m, _ in CASES) == 19


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m}::{c[0]}" for m, c in CASES])
def test_jax_case_on_the_port(module, case):
    """The JAX test's case as written, on the port's modules."""
    _id, cls_name, name, params = case
    run_twin_case(TWINS[module], cls_name, name, params)


# -- sequence_utils -----------------------------------------------------------

ALPHABETS = ("STRICT_DNA_COMPLEMENT_UPPER", "DNA_COMPLEMENT_UPPER",
             "IUPAC_DNA_COMPLEMENT_UPPER", "STRICT_DNA_COMPLEMENT",
             "DNA_COMPLEMENT", "IUPAC_DNA_COMPLEMENT", None)
SEQUENCES = ("", "ACGT", "acgtN", "GGGCAGANN", "RYSWKMBVDHN",
             "ryswkmbvdhnACGT", "ACGTX", "-")


def _rc(module, seq, alphabet):
    table = getattr(module, alphabet) if alphabet else None
    try:
        return module.reverse_complement(seq, table)
    except module.Error as e:
        return ("error", str(e))


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_reverse_complement_on_every_alphabet(alphabet):
    for seq in SEQUENCES:
        assert _rc(tsu, seq, alphabet) == _rc(jsu, seq, alphabet), seq


def test_tables_and_base_sets_equal():
    names = [n for n in dir(jsu) if n.isupper()]
    assert names == [n for n in dir(tsu) if n.isupper()]
    for name in names:
        assert getattr(tsu, name) == getattr(jsu, name), name


# -- graphs -------------------------------------------------------------------

def _g(node, reverse=False):
    return (node << 1) | int(reverse)


def _bubble():
    """test_gbz.py's bubble graph: SNP, insertion and deletion paths."""
    nodes = {1: "ACGTA", 2: "C", 3: "T", 4: "GGAT", 5: "AA", 6: "TT",
             7: "ACGT"}
    paths = [[_g(1), _g(2), _g(4), _g(6), _g(7)],
             [_g(1), _g(3), _g(4), _g(6), _g(7)],
             [_g(1), _g(2), _g(4), _g(5), _g(6), _g(7)],
             [_g(1), _g(2), _g(4), _g(7)]]
    names = [(0, 0, 0, 0), (1, 0, 1, 0), (2, 0, 2, 0), (3, 0, 1, 0)]
    return (nodes, paths, names, ["GRCh38", "HG002", "HG002", "HG003"],
            ["chr20"], "ACGTACGGATTTACGT")


def _reverse():
    """test_gbz.py's orientation graph: one node walked in reverse."""
    nodes = {1: "ACGTA", 2: "GGC", 3: "TT"}
    paths = [[_g(1), _g(2), _g(3)], [_g(1), _g(2, True), _g(3)]]
    return (nodes, paths, [(0, 0, 0, 0), (1, 0, 1, 0)], ["GRCh38", "S1"],
            ["c"], "ACGTAGGCTT")


def _panel(contig_lengths):
    def make():
        panel = synthetic.synthetic_pangenome(
            13, contig_lengths, depth=1)["panel"]
        return synthetic.panel_graph(panel) + (panel,)
    return make


GRAPHS = {"bubble": _bubble, "reverse": _reverse,
          "panel": _panel((("chr1", 3000),)),
          "panel-two-contigs": _panel((("chr1", 2000), ("chr2", 1500)))}


def _write(module, graph, path):
    nodes, paths, names, samples, contigs = graph[:5]
    module.write_gbz(path, nodes, paths, module.GbwtMetadata(
        sample_names=samples, contig_names=contigs,
        path_names=[module.PathName(*n) for n in names]))
    return path


def _reference_fasta(graph, directory):
    """A FASTA of the graph's reference path(s), for the panel BAM."""
    if isinstance(graph[-1], dict):
        return synthetic.write_fasta(graph[-1],
                                     os.path.join(directory, "ref.fa"))
    path = os.path.join(directory, "ref.fa")
    name, bases = graph[4][0], graph[5]
    with open(path, "w") as f:
        f.write(f">{name}\n{bases}\n")
    with open(path + ".fai", "w") as f:
        f.write(f"{name}\t{len(bases)}\t{len(name) + 2}\t{len(bases)}\t"
                f"{len(bases) + 1}\n")
    return path


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph_files(request, tmp_path_factory):
    graph = GRAPHS[request.param]()
    d = str(tmp_path_factory.mktemp(f"gbz_{request.param}"))
    return dict(name=request.param, graph=graph, dir=d,
                jax=_write(jgbz, graph, os.path.join(d, "jax.gbz")),
                port=_write(tgbz, graph, os.path.join(d, "port.gbz")))


def test_write_gbz_bytes_equal(graph_files):
    assert read_bytes(graph_files["port"]) == read_bytes(graph_files["jax"])


def test_read_gbz_paths_and_metadata(graph_files):
    """Each package reads the other's file: the same records, sequences,
    paths, bases and metadata, and the paths as written."""
    paths = graph_files["graph"][1]
    for reader, writer_file in ((tgbz, "jax"), (jgbz, "port")):
        got = reader.read_gbz(graph_files[writer_file])
        want = (jgbz if reader is tgbz else tgbz).read_gbz(
            graph_files[writer_file])
        assert got.gbwt.sequences == want.gbwt.sequences == len(paths)
        assert got.gbwt.records == want.gbwt.records
        assert got.node_sequences == want.node_sequences
        md, wmd = got.gbwt.metadata, want.gbwt.metadata
        assert (md.sample_names, md.contig_names, md.haplotype_count) == (
            wmd.sample_names, wmd.contig_names, wmd.haplotype_count)
        assert [vars(p) for p in md.path_names] == [
            vars(p) for p in wmd.path_names]
        for seq_id, path in enumerate(paths):
            assert got.path_nodes(seq_id) == path
            assert got.path_bases(seq_id) == want.path_bases(seq_id)
            assert got.contig_name(seq_id) == want.contig_name(seq_id)
        for sample in md.sample_names + ["absent"]:
            assert got.paths_for_sample(sample) == \
                want.paths_for_sample(sample)


def test_haplotype_reads_equal(graph_files):
    """The haplotype paths projected onto the reference sample's path,
    whole and over a region, field by field."""
    got = tgbz.read_gbz(graph_files["port"])
    want = jgbz.read_gbz(graph_files["jax"])
    contig = got.gbwt.metadata.contig_names[0]
    assert_reads_equal(got.haplotype_reads("GRCh38"),
                       want.haplotype_reads("GRCh38"))
    assert_reads_equal(
        got.haplotype_reads("GRCh38", TRange(contig, 3, 9)),
        want.haplotype_reads("GRCh38", JRange(contig, 3, 9)))
    # Matches, and the insertion and deletion of every bubble.
    ops = {op for r in got.haplotype_reads("GRCh38") for op, _ in r.cigar}
    assert {1, 2, 3} <= ops
    for module in (tgbz, jgbz):
        with pytest.raises(ValueError, match="reference sample"):
            module.read_gbz(graph_files["port"]).haplotype_reads("absent")


def test_panel_bam_and_index_equal(graph_files):
    d = graph_files["dir"]
    ref = _reference_fasta(graph_files["graph"], d)
    outs = []
    for module, tag in ((jgbz, "jax"), (tgbz, "port")):
        path = module.extract_panel_bam(graph_files[tag], ref,
                                        os.path.join(d, f"{tag}.panel.bam"))
        outs.append((read_bytes(path), read_bytes(path + ".bai")))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) > 100


def test_panel_bam_refuses_unread_regions(graph_files, tmp_path):
    """The JAX `extract_panel_bam` takes `regions` and reads it nowhere:
    its panel is the same with and without. The port refuses it."""
    ref = _reference_fasta(graph_files["graph"], str(tmp_path))
    plain = jgbz.extract_panel_bam(graph_files["jax"], ref,
                                   str(tmp_path / "plain.bam"))
    regioned = jgbz.extract_panel_bam(graph_files["jax"], ref,
                                      str(tmp_path / "regioned.bam"),
                                      regions=["chr1:1-100"])
    assert read_bytes(plain) == read_bytes(regioned)
    with pytest.raises(NotImplementedError,
                       match=r"Queue 3 \(unread product-driver options\)"):
        tgbz.extract_panel_bam(graph_files["port"], ref,
                               str(tmp_path / "port.bam"),
                               regions=["chr1:1-100"])
