"""VCF reader/writer with the DeepVariant header and record formatting.

The port's copy of `deepvariant_tpu.io.vcf`, byte for byte in what it
writes: a pure-Python equivalent of the reference's htslib-backed nucleus
VCF layer (`third_party/nucleus/io/vcf_writer.{h,cc}`,
`vcf_conversion.cc`) plus the DeepVariant header recipe (`deepvariant/dv_vcf_constants.py:84-204`).
Output is plain text or BGZF (so the result is tabix-indexable).

Value formatting follows htslib conventions (`%g`-style floats) so records
diff cleanly against reference-produced VCFs.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from deepvariant_tpu_torch.core.types import (
    ContigInfo,
    Range,
    Variant,
    VariantCall,
)
from deepvariant_tpu_torch.io.bgzf import BgzfReader, BgzfWriter, is_bgzf

DEEP_VARIANT_VERSION = "1.10.0"  # data-contract version we match

# FILTER field IDs (dv_vcf_constants.py:39-45).
PASS_FILTER = "PASS"
REF_FILTER = "RefCall"
QUAL_FILTER = "LowQual"
NO_CALL_FILTER = "NoCall"
GERMLINE_FILTER = "GERMLINE"
PON_FILTER = "PON"

UNCALLED_GENOTYPE = -1

_FILTER_LINES = [
    ('PASS', 'All filters passed'),
    (REF_FILTER, 'Genotyping model thinks this site is reference.'),
    (QUAL_FILTER,
     'Confidence in this variant being real is below calling threshold.'),
    (NO_CALL_FILTER, 'Site has depth=0 resulting in no call.'),
]

_INFO_LINES = [
    ('END', '1', 'Integer', 'Stop position of the interval'),
]

_FORMAT_LINES = [
    ('GT', '1', 'String', 'Genotype'),
    ('GQ', '1', 'Integer', 'Conditional genotype quality'),
    ('DP', '1', 'Integer', 'Read depth'),
    ('MIN_DP', '1', 'Integer', 'Minimum DP observed within the GVCF block.'),
    ('AD', 'R', 'Integer',
     'Read depth for each allele'),
    ('VAF', 'A', 'Float',
     'Variant allele fractions.'),
    ('GL', 'G', 'Float', 'Genotype likelihoods, log10 encoded'),
    ('PL', 'G', 'Integer', 'Phred-scaled genotype likelihoods rounded to the '
     'closest integer'),
    ('MED_DP', '1', 'Integer',
     'Median DP observed within the GVCF block rounded to the nearest '
     'integer.'),
    ('PS', '1', 'Integer', 'Phase set'),
    ('MF', 'R', 'Float',
     'Methylation fraction for each of the reference and alternate '
     'allele'),
    ('MD', 'R', 'Integer',
     'Methylation depth for each of the reference and alternate allele'),
    ('MT', '1', 'String',
     'Methylation type: 0/0=Unmethylated, 0/1=Heterozygous, '
     '1/1=Methylated'),
    ('MI', '1', 'Float',
     'Allele-specific methylation score: p-value for Wilcoxon '
     'Rank-Sum test based on the observed difference in methylation '
     'between haplotypes.'),
]


def format_float(value: float) -> str:
    """htslib-style %g float formatting (vcf.c uses %g for QUAL/floats)."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return "."
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(round(value, 6)) if abs(value) >= 1e-4 else f"{value:g}"


def _format_qual(q: float) -> str:
    if q is None:
        return "."
    # Reference rounds QUAL to one decimal before write
    # (vcf_writer.cc:187-192: floor(q*10 + 0.5) / 10), then %g.
    q = math.floor(q * 10 + 0.5) / 10
    return f"{q:g}"


class VcfHeader:
    """Structured VCF header (nucleus VcfHeader proto equivalent)."""

    def __init__(
        self,
        contigs: Sequence[ContigInfo],
        sample_names: Sequence[str],
        extras: Optional[Sequence[Tuple[str, str]]] = None,
        extra_format_lines: Optional[Sequence[Tuple[str, str, str, str]]] = None,
        extra_filter_lines: Optional[Sequence[Tuple[str, str]]] = None,
    ):
        self.contigs = list(contigs)
        self.sample_names = list(sample_names)
        self.extras = list(extras or [])
        self.extra_format_lines = list(extra_format_lines or [])
        self.extra_filter_lines = list(extra_filter_lines or [])

    def lines(self) -> List[str]:
        out = ["##fileformat=VCFv4.2"]
        for fid, desc in list(_FILTER_LINES) + self.extra_filter_lines:
            out.append(f'##FILTER=<ID={fid},Description="{desc}">')
        for iid, num, typ, desc in _INFO_LINES:
            out.append(
                f'##INFO=<ID={iid},Number={num},Type={typ},'
                f'Description="{desc}">'
            )
        for fid, num, typ, desc in list(_FORMAT_LINES) + self.extra_format_lines:
            out.append(
                f'##FORMAT=<ID={fid},Number={num},Type={typ},'
                f'Description="{desc}">'
            )
        for key, value in [("DeepVariant_version", DEEP_VARIANT_VERSION)] + \
                self.extras:
            out.append(f"##{key}={value}")
        for c in self.contigs:
            out.append(f"##contig=<ID={c.name},length={c.n_bases}>")
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO",
                "FORMAT"] + self.sample_names
        out.append("\t".join(cols))
        return out


# FORMAT fields specific to T-N somatic calling
# (dv_vcf_constants.py:57-79 SOMATIC_FORMAT_FIELDS).
SOMATIC_FORMAT_LINES = [
    ('NDP', '1', 'Integer', 'Number of reads in the normal sample.'),
    ('NAD', 'R', 'Integer',
     'Read depth in the normal sample for alleles reported in the '
     'tumor sample'),
    ('NAF', 'R', 'Float', 'VAF of ALT alleles in the normal sample.'),
]


def deepvariant_header(
    contigs: Sequence[ContigInfo], sample_names: Sequence[str],
    extra_filter_lines: Optional[Sequence[Tuple[str, str]]] = None,
    include_somatic_fields: bool = False,
) -> VcfHeader:
    """The standard DeepVariant output header (dv_vcf_constants.py:84)."""
    return VcfHeader(
        contigs, sample_names,
        extra_filter_lines=extra_filter_lines,
        extra_format_lines=(
            SOMATIC_FORMAT_LINES if include_somatic_fields else None
        ),
    )


def _format_info(info: Dict[str, List]) -> str:
    if not info:
        return "."
    parts = []
    for key, values in info.items():
        if values is True or values == [True]:
            parts.append(key)
            continue
        if not isinstance(values, (list, tuple)):
            values = [values]
        formatted = ",".join(
            format_float(v) if isinstance(v, float) else str(v)
            for v in values
        )
        parts.append(f"{key}={formatted}")
    return ";".join(parts) if parts else "."


def _format_gt(call: VariantCall) -> str:
    if not call.genotype:
        return "."
    sep = "|" if call.is_phased else "/"
    return sep.join(
        "." if g == UNCALLED_GENOTYPE else str(g) for g in call.genotype
    )


# FORMAT keys we know how to emit, in canonical order. The reference
# writer emits PL (phred-scaled) and never GL (see
# golden.postprocess_single_site_output.vcf: GT:GQ:DP:AD:VAF:PL).
_FORMAT_ORDER = ["GT", "GQ", "DP", "MIN_DP", "AD", "VAF", "PL",
                 "MED_DP", "PS", "MF", "MD", "MT", "MI",
                 "NDP", "NAD", "NAF"]


def format_variant_line(variant: Variant) -> str:
    """Render one Variant proto as a VCF data line."""
    chrom = variant.reference_name
    pos = variant.start + 1
    vid = ";".join(variant.names) if variant.names else "."
    ref = variant.reference_bases or "."
    alt = ",".join(variant.alternate_bases) if variant.alternate_bases \
        else "."
    qual = _format_qual(variant.quality) if variant.quality else "0"
    filt = ";".join(variant.filter) if variant.filter else "."
    info = dict(variant.info)
    # gVCF ref blocks carry END; derive it from variant.end when the
    # record spans beyond its reference bases (nucleus writes END for
    # any record whose end != start + len(ref)).
    if "END" in info:
        info = {"END": info["END"]}
    elif variant.alternate_bases == ["<*>"]:
        # Pure gVCF ref blocks always carry END, even 1bp ones
        # (golden.postprocess_gvcf_output.g.vcf).
        info = {"END": [variant.end]}
    line = [chrom, str(pos), vid, ref, alt, qual, filt, _format_info(info)]

    if variant.calls:
        call = variant.calls[0]
        fields: Dict[str, str] = {"GT": _format_gt(call)}
        ci = call.info
        if "GQ" in ci:
            fields["GQ"] = str(int(ci["GQ"][0]))
        if "DP" in ci:
            fields["DP"] = str(int(ci["DP"][0]))
        if "MIN_DP" in ci:
            fields["MIN_DP"] = str(int(ci["MIN_DP"][0]))
        if "AD" in ci:
            fields["AD"] = ",".join(str(int(v)) for v in ci["AD"])
        if "VAF" in ci:
            fields["VAF"] = ",".join(format_float(float(v))
                                     for v in ci["VAF"])
        if call.genotype_likelihood:
            # PL = int(-10*(GL - max GL)); the int cast truncates, exactly
            # like vcf_conversion.cc:1225-1229 (double->int std::transform).
            m = max(call.genotype_likelihood)
            fields["PL"] = ",".join(
                str(int(-10.0 * (gl - m)))
                for gl in call.genotype_likelihood
            )
        if "MED_DP" in ci:
            fields["MED_DP"] = str(int(ci["MED_DP"][0]))
        if "PS" in ci:
            fields["PS"] = str(int(ci["PS"][0]))
        if "MF" in ci:
            fields["MF"] = ",".join(
                format_float(float(v)) for v in ci["MF"]
            )
        if "MD" in ci:
            fields["MD"] = ",".join(str(int(v)) for v in ci["MD"])
        if "MT" in ci:
            fields["MT"] = str(ci["MT"][0])
        if "MI" in ci:
            fields["MI"] = format_float(float(ci["MI"][0]))
        if "NDP" in ci:
            fields["NDP"] = str(int(ci["NDP"][0]))
        if "NAD" in ci:
            fields["NAD"] = ",".join(str(int(v)) for v in ci["NAD"])
        if "NAF" in ci:
            fields["NAF"] = ",".join(
                format_float(float(v)) for v in ci["NAF"]
            )
        keys = [k for k in _FORMAT_ORDER if k in fields]
        line.append(":".join(keys))
        line.append(":".join(fields[k] for k in keys))
    return "\t".join(line)


class VcfWriter:
    """Writes Variants to a (b)gzipped or plain VCF file."""

    def __init__(self, path: str, header: VcfHeader, round_qualities=True):
        self.path = path
        self.header = header
        if path.endswith(".gz"):
            self._fh = BgzfWriter(path)
            self._write = lambda s: self._fh.write(s.encode())
        else:
            self._raw = open(path, "w")
            self._write = self._raw.write
        for line in header.lines():
            self._write(line + "\n")

    def write(self, variant: Variant):
        self._write(format_variant_line(variant) + "\n")

    def close(self):
        if hasattr(self, "_fh"):
            self._fh.close()
        else:
            self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

_NUMERIC_RE = re.compile(r"^-?\d+$")
_FLOAT_RE = re.compile(r"^-?\d*\.?\d+([eE][-+]?\d+)?$")


def _parse_value(text: str):
    if _NUMERIC_RE.match(text):
        return int(text)
    if _FLOAT_RE.match(text):
        return float(text)
    return text


def parse_vcf_line(line: str, sample_names: Sequence[str]) -> Variant:
    cols = line.rstrip("\n").split("\t")
    v = Variant(
        reference_name=cols[0],
        start=int(cols[1]) - 1,
        reference_bases=cols[3],
        alternate_bases=[] if cols[4] == "." else cols[4].split(","),
    )
    if cols[2] != ".":
        v.names = cols[2].split(";")
    v.quality = float(cols[5]) if cols[5] != "." else 0.0
    if cols[6] != ".":
        v.filter = cols[6].split(";")
    v.end = v.start + len(v.reference_bases)
    if cols[7] != ".":
        for item in cols[7].split(";"):
            if "=" in item:
                key, val = item.split("=", 1)
                v.info[key] = [_parse_value(x) for x in val.split(",")]
            else:
                v.info[item] = [True]
        if "END" in v.info:
            v.end = int(v.info["END"][0])
    if len(cols) > 9:
        keys = cols[8].split(":")
        for si, sample_col in enumerate(cols[9:]):
            call = VariantCall(
                call_set_name=sample_names[si]
                if si < len(sample_names) else f"sample{si}"
            )
            for key, val in zip(keys, sample_col.split(":")):
                if key == "GT":
                    call.is_phased = "|" in val
                    call.genotype = [
                        UNCALLED_GENOTYPE if g == "." else int(g)
                        for g in re.split(r"[/|]", val)
                    ] if val != "." else [UNCALLED_GENOTYPE,
                                          UNCALLED_GENOTYPE]
                elif key == "GL":
                    call.genotype_likelihood = [
                        float(x) for x in val.split(",") if x != "."
                    ]
                elif key == "PS":
                    call.phaseset = val
                    if val not in (".", ""):
                        # PS is Integer per spec, but e.g. GIAB truth
                        # sets declare Type=String (PATMAT/HOMVAR).
                        try:
                            call.info["PS"] = [int(val)]
                        except ValueError:
                            call.info["PS"] = [val]
                elif val != ".":
                    call.info[key] = [_parse_value(x)
                                      for x in val.split(",")]
            v.calls.append(call)
    return v


class VcfReader:
    """Iterates Variants from a VCF(.gz) file; supports simple queries."""

    def __init__(self, path: str):
        self.path = path
        self.header_lines: List[str] = []
        self.sample_names: List[str] = []
        self.contigs: List[ContigInfo] = []
        self._open()

    def _open(self):
        if self.path.endswith(".gz") and is_bgzf(self.path):
            data = BgzfReader(self.path).read_all().decode()
            self._lines = data.splitlines()
        elif self.path.endswith(".gz"):
            import gzip

            with gzip.open(self.path, "rt") as f:
                self._lines = f.read().splitlines()
        else:
            with open(self.path) as f:
                self._lines = f.read().splitlines()
        self._body_start = 0
        for i, line in enumerate(self._lines):
            if line.startswith("##"):
                self.header_lines.append(line)
                m = re.match(r"##contig=<ID=([^,>]+)(?:,length=(\d+))?", line)
                if m:
                    self.contigs.append(
                        ContigInfo(
                            name=m.group(1),
                            n_bases=int(m.group(2) or 0),
                            pos_in_fasta=len(self.contigs),
                        )
                    )
            elif line.startswith("#CHROM"):
                self.sample_names = line.split("\t")[9:]
                self._body_start = i + 1
                break

    def __iter__(self) -> Iterator[Variant]:
        for line in self._lines[self._body_start:]:
            if line:
                yield parse_vcf_line(line, self.sample_names)

    def _ensure_query_index(self):
        """Parse once and group records per contig for repeated queries.

        Labeling runs call query() once per ~1kb region; re-parsing the
        whole file each time is O(records x regions). For files sorted
        per contig (the VCF norm) we binary-search on a prefix-max of
        record ends; unsorted contigs fall back to a linear scan over
        the parsed records (same semantics either way).
        """
        if getattr(self, "_query_index", None) is not None:
            return
        import bisect

        parsed: List[Variant] = list(self)
        index: Dict[str, tuple] = {}
        groups: Dict[str, List[Variant]] = {}
        for v in parsed:
            groups.setdefault(v.reference_name, []).append(v)
        for contig, records in groups.items():
            starts = [v.start for v in records]
            is_sorted = all(
                starts[i] <= starts[i + 1] for i in range(len(starts) - 1)
            )
            prefix_max_end: List[int] = []
            running = -1
            for v in records:
                running = max(running, v.end)
                prefix_max_end.append(running)
            index[contig] = (records, starts, prefix_max_end, is_sorted)
        self._query_index = index
        self._bisect = bisect

    def query(self, region: Range) -> Iterator[Variant]:
        self._ensure_query_index()
        entry = self._query_index.get(region.reference_name)
        if entry is None:
            return
        records, starts, prefix_max_end, is_sorted = entry
        if not is_sorted:
            for v in records:
                if v.start < region.end and v.end > region.start:
                    yield v
            return
        # First record whose prefix-max end exceeds region.start: nothing
        # before it can overlap (prefix_max_end is non-decreasing).
        i = self._bisect.bisect_right(prefix_max_end, region.start)
        while i < len(records) and starts[i] < region.end:
            v = records[i]
            if v.end > region.start:
                yield v
            i += 1

    def close(self):
        self._lines = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
