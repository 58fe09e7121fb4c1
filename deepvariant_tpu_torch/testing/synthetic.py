"""A seeded synthetic sample: reference, planted variants, aligned reads.

Test data for stage 1, made with numpy from a seed and returned as plain
arrays, so that the same sample can be written by either package's
writers (`write_inputs` takes the modules to use). Nothing here models
a sequencer; it only has to put every kind of record in front of the
readers, the allele counter and the planners:

- a reference of named contigs with a run of N and a repeated segment;
- a diploid sample with SNPs, insertions, deletions and multi-allelic
  sites (a different alt on each haplotype) planted at a fixed spacing;
- paired 150-base reads at a given depth, with substitution errors, low
  base qualities, soft clips at either end, a few hard clips, unpaired
  reads, mates on the other contig, `tlen` of either sign, duplicates
  (same name, flag 0x400), secondary and supplementary flags, low mapq,
  and aux blobs with NM, RG and, on some reads, an HP tag.

`synthetic_longread_sample` is the long-read form: single-end reads of a
few kb with indel and substitution errors in their alignments, for the
PacBio and ONT presets.

`add_read_options` and `add_methylation` put the aux tags of the
read-side options on a sample's reads, each from its own seed, so a
sample made without them keeps its bytes: OQ (some of the wrong
length), Ultima's tp and t0, and indels written right-shifted in
homopolymers for `--normalize_reads`; MM/ML 5mC at CpGs, with
haplotype-specific levels at a share of them, and some 6mA.

`write_truth_inputs` writes the inputs of training mode: a truth VCF of
the planted variants and their genotypes (with a few left out and a few
added that no read carries) and a BED of confident regions.

`write_vcf_inputs` writes the VCF inputs of stage 1 from a sample's
planted variants: a population VCF with an AF per alt (for the
allele_frequency channel), a VCF of proposed variants (for the
vcf_candidate_importer) and a VCF of variants to exclude, each bgzipped
and tabix-indexed by the port's own writers, each only when asked for.

`keras_inception_stand_in` is a seeded numpy stand-in of a keras
InceptionV3, layers and weights in keras's order and layouts, for the
keras import where TensorFlow is not installed.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

# CIGAR op codes as the ReadBatch stores them (proto codes).
_M, _I, _D, _N, _S, _H = 1, 2, 3, 4, 5, 6
_BASES = np.frombuffer(b"ACGT", np.uint8)


def _reference(rng, length: int) -> np.ndarray:
    ref = _BASES[rng.randint(0, 4, length)].copy()
    # A repeated segment, a homopolymer and a run of N.
    seg = max(40, length // 50)
    a = length // 5
    b = length // 2
    ref[b:b + seg] = ref[a:a + seg]
    ref[a + 2 * seg:a + 2 * seg + 25] = ord("A")
    n0 = (3 * length) // 4
    ref[n0:n0 + min(400, length // 20)] = ord("N")
    return ref


def _plant(rng, ref: np.ndarray, spacing: int) -> List[dict]:
    """Variants every `spacing` bases, none in or next to the N run."""
    out = []
    pos = 120
    k = 0
    while pos < len(ref) - 200:
        window = ref[pos - 1:pos + 12]
        if (window == ord("N")).any():
            pos += spacing
            continue
        kind = ("snp", "snp", "snp", "ins", "del", "snp", "multi")[k % 7]
        ref_base = chr(ref[pos])
        others = [b for b in "ACGT" if b != ref_base]
        if kind == "snp":
            alts = [others[rng.randint(3)]]
            alleles = [("snp", alts[0])]
        elif kind == "ins":
            ins = "".join("ACGT"[i] for i in rng.randint(0, 4, rng.randint(1, 7)))
            alleles = [("ins", ins)]
        elif kind == "del":
            alleles = [("del", int(rng.randint(1, 9)))]
        else:
            # Two alts at one site, one per haplotype: SNP + SNP, or
            # SNP + insertion.
            second = ("snp", others[1]) if k % 14 == 6 else (
                "ins", "".join("ACGT"[i] for i in rng.randint(0, 4, 3)))
            alleles = [("snp", others[0]), second]
        if len(alleles) == 2:
            haps = (0, 1)          # alleles[0] on hap 0, alleles[1] on hap 1
        else:
            haps = ((0,), (1,), (0, 1))[rng.randint(3)]  # het, het, hom
        out.append(dict(pos=pos, alleles=alleles, haps=haps))
        pos += spacing + int(rng.randint(0, spacing // 4 + 1))
        k += 1
    return out


def _hap_allele(v: dict, hap: int):
    if len(v["alleles"]) == 2:
        return v["alleles"][hap]
    return v["alleles"][0] if hap in v["haps"] else None


def _read_from(ref, by_pos, start: int, hap: int, length: int):
    """Walk the haplotype from `start`: (bases, cigar units)."""
    seq: List[int] = []
    cigar: List[List[int]] = []

    def add(op, n):
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += n
        else:
            cigar.append([op, n])

    pos = start
    while len(seq) < length and pos < len(ref):
        v = by_pos.get(pos)
        allele = _hap_allele(v, hap) if v is not None else None
        base = int(ref[pos])
        if allele is None:
            seq.append(base)
            add(_M, 1)
            pos += 1
        elif allele[0] == "snp":
            seq.append(ord(allele[1]))
            add(_M, 1)
            pos += 1
        elif allele[0] == "ins":
            seq.append(base)
            add(_M, 1)
            pos += 1
            room = length - len(seq)
            ins = allele[1][:room]
            # An insertion may not end a read: drop it when no base
            # follows.
            if ins and room > len(ins):
                seq.extend(ins.encode())
                add(_I, len(ins))
        else:
            seq.append(base)
            add(_M, 1)
            pos += 1
            if len(seq) < length and pos + allele[1] < len(ref):
                add(_D, allele[1])
                pos += allele[1]
    return seq, cigar


def synthetic_sample(
    seed: int,
    contig_lengths: Sequence[Tuple[str, int]] = (("chr1", 6000),
                                                 ("chr2", 3000)),
    depth: int = 30,
    read_length=150,
    variant_spacing: int = 70,
    sample_name: str = "synthetic",
    skip_fraction: float = 0.0,
) -> dict:
    """The sample as plain values: `contigs` [(name, length)],
    `reference` {name: uint8 bases}, `variants` {name: planted variants},
    `reads` (columnar arrays and lists, coordinate sorted) and
    `sample_name`. `read_length` may be a list of lengths, one drawn for
    each pair; `skip_fraction` of the reads get a reference skip (an N
    op of 20-40 bases) inside their first match, as spliced RNA reads
    have. Both draw from the seed only when asked for, so every sample
    made without them keeps its bytes."""
    rng = np.random.RandomState(seed)
    names = [n for n, _ in contig_lengths]
    reference = {}
    variants = {}
    rows = []
    serial = 0
    for ref_id, (name, length) in enumerate(contig_lengths):
        ref = _reference(rng, length)
        reference[name] = ref
        planted = _plant(rng, ref, variant_spacing)
        variants[name] = planted
        by_pos = {v["pos"]: v for v in planted}
        lengths = [read_length] if isinstance(read_length, int) \
            else list(read_length)
        n_pairs = depth * length * len(lengths) // (2 * sum(lengths))
        for _ in range(n_pairs):
            read_length = lengths[0] if len(lengths) == 1 else \
                int(lengths[rng.randint(len(lengths))])
            insert = int(np.clip(rng.normal(400, 60), read_length + 10, 700))
            start = int(rng.randint(0, max(1, length - insert - 20)))
            hap = int(rng.randint(2))
            name_i = f"frag{serial:06d}"
            serial += 1
            mapq = int(rng.randint(0, 5)) if rng.rand() < 0.05 else \
                int(rng.randint(20, 61))
            kind = rng.rand()
            ends = []
            for which, s in ((0, start), (1, start + insert - read_length)):
                seq, cigar = _read_from(ref, by_pos, s, hap, read_length)
                if skip_fraction and rng.rand() < skip_fraction and \
                        cigar[0][1] > 80:
                    # The bases under the skip leave the read.
                    k = int(rng.randint(20, 41))
                    a = int(rng.randint(20, cigar[0][1] - k - 10))
                    rest = cigar[0][1] - a - k
                    cigar[0:1] = [[_M, a], [_N, k], [_M, rest]]
                    del seq[a:a + k]
                seq = np.array(seq, np.uint8)
                # Substitution errors and base qualities.
                errs = np.flatnonzero(rng.rand(len(seq)) < 0.004)
                seq[errs] = _BASES[rng.randint(0, 4, len(errs))]
                qual = rng.randint(20, 41, len(seq)).astype(np.uint8)
                low = rng.rand(len(seq)) < 0.03
                qual[low] = rng.randint(2, 10, int(low.sum()))
                pos = s
                # Soft clips: the clipped bases stay in the read, the
                # alignment starts after them.
                if rng.rand() < 0.08 and cigar[0][0] == _M and \
                        cigar[0][1] > 25:
                    k = int(rng.randint(3, 21))
                    cigar[0][1] -= k
                    cigar.insert(0, [_S, k])
                    seq[:k] = _BASES[rng.randint(0, 4, k)]
                    pos += k
                if rng.rand() < 0.08 and cigar[-1][0] == _M and \
                        cigar[-1][1] > 25:
                    k = int(rng.randint(3, 21))
                    cigar[-1][1] -= k
                    cigar.append([_S, k])
                    seq[-k:] = _BASES[rng.randint(0, 4, k)]
                if rng.rand() < 0.02:
                    if rng.rand() < 0.5:
                        cigar.insert(0, [_H, int(rng.randint(5, 40))])
                    else:
                        cigar.append([_H, int(rng.randint(5, 40))])
                ends.append(dict(pos=pos, seq=seq, qual=qual, cigar=cigar,
                                 which=which))
            for e, mate in ((ends[0], ends[1]), (ends[1], ends[0])):
                which = e["which"]
                flag = 0x1 | 0x2 | (0x40 if which == 0 else 0x80)
                flag |= 0x10 if which == 1 else 0x20
                mate_ref, mate_pos = ref_id, mate["pos"]
                tlen = insert if which == 0 else -insert
                this_mapq = mapq
                if kind < 0.04:
                    # Unpaired fragment: only its first read is kept.
                    if which == 1:
                        continue
                    flag, mate_ref, mate_pos, tlen = 0, -1, -1, 0
                elif kind < 0.06:
                    # Mate on the other contig, not a proper pair.
                    flag &= ~0x2
                    mate_ref = (ref_id + 1) % len(names)
                    mate_pos = int(rng.randint(0, 1000))
                    tlen = 0
                elif kind < 0.08:
                    flag = (flag & ~0x2) | 0x8     # mate unmapped
                    tlen = 0
                elif kind < 0.10:
                    flag |= 0x100 if which == 0 else 0x800
                elif kind < 0.11:
                    flag |= 0x200                  # vendor QC fail
                aux = b"NMC" + bytes([int(rng.randint(0, 6))]) + \
                    b"RGZrg1\x00"
                if rng.rand() < 0.3:
                    aux += b"HPC" + bytes([int(rng.randint(1, 3))])
                row = dict(name=name_i, flag=flag, ref_id=ref_id,
                           pos=e["pos"], mapq=this_mapq, seq=e["seq"],
                           qual=e["qual"], cigar=e["cigar"],
                           mate_ref_id=mate_ref, mate_pos=mate_pos,
                           tlen=tlen, aux=aux)
                rows.append(row)
                if rng.rand() < 0.03:
                    rows.append(dict(row, flag=flag | 0x400))
    return dict(contigs=list(contig_lengths), reference=reference,
                variants=variants, reads=_pack_reads(rows),
                sample_name=sample_name)


def _pack_reads(rows: List[dict]) -> dict:
    """Read rows, coordinate sorted, as the columns of a ReadBatch."""
    rows.sort(key=lambda r: (r["ref_id"], r["pos"]))
    n = len(rows)
    seq_off = np.zeros(n + 1, np.int64)
    cig_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(r["seq"]) for r in rows], out=seq_off[1:])
    np.cumsum([len(r["cigar"]) for r in rows], out=cig_off[1:])
    flat_cigar = [u for r in rows for u in r["cigar"]]
    return dict(
        name=[r["name"] for r in rows],
        aux=[r["aux"] for r in rows],
        flag=np.array([r["flag"] for r in rows], np.uint16),
        ref_id=np.array([r["ref_id"] for r in rows], np.int32),
        pos=np.array([r["pos"] for r in rows], np.int64),
        mapq=np.array([r["mapq"] for r in rows], np.uint8),
        mate_ref_id=np.array([r["mate_ref_id"] for r in rows], np.int32),
        mate_pos=np.array([r["mate_pos"] for r in rows], np.int64),
        tlen=np.array([r["tlen"] for r in rows], np.int32),
        seq=np.concatenate([r["seq"] for r in rows]),
        qual=np.concatenate([r["qual"] for r in rows]),
        seq_offsets=seq_off,
        cigar_ops=np.array([u[0] for u in flat_cigar], np.int8),
        cigar_lens=np.array([u[1] for u in flat_cigar], np.int32),
        cigar_offsets=cig_off,
        hp=np.zeros(n, np.int8),
    )


def _long_read_from(rng, ref, by_pos, start: int, hap: int, length: int,
                    sub_rate: float, ins_rate: float, del_rate: float):
    """Walk the haplotype from `start` as `_read_from` does, with
    sequencing errors written into the alignment: substitutions, and
    one- or two-base insertions and one-base deletions that mostly
    lengthen or shorten a homopolymer. (bases, cigar units); the
    alignment starts and ends on a match."""
    seq: List[int] = []
    cigar: List[List[int]] = []

    def add(op, n):
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += n
        else:
            cigar.append([op, n])

    draws = rng.rand(length + 8)
    picks = rng.randint(0, 4, length + 8)
    pos = start
    step = 0
    while len(seq) < length and pos < len(ref):
        v = by_pos.get(pos)
        allele = _hap_allele(v, hap) if v is not None else None
        base = int(ref[pos])
        u = draws[step % len(draws)]
        pick = int(picks[step % len(picks)])
        step += 1
        if allele is None:
            clean = base != ord("N") and seq and cigar[-1][0] == _M
            if clean and u < del_rate and pos + 1 < len(ref):
                add(_D, 1)
                pos += 1
                continue
            if clean and u < del_rate + sub_rate:
                base = int(_BASES[pick])
            seq.append(base)
            add(_M, 1)
            pos += 1
            if clean and del_rate + sub_rate <= u < \
                    del_rate + sub_rate + ins_rate:
                ins = [base] * (1 + pick % 2) if pick else [int(_BASES[1])]
                if length - len(seq) > len(ins):
                    seq.extend(ins)
                    add(_I, len(ins))
        elif allele[0] == "snp":
            seq.append(ord(allele[1]))
            add(_M, 1)
            pos += 1
        elif allele[0] == "ins":
            seq.append(base)
            add(_M, 1)
            pos += 1
            room = length - len(seq)
            ins = allele[1][:room]
            if ins and room > len(ins):
                seq.extend(ins.encode())
                add(_I, len(ins))
        else:
            seq.append(base)
            add(_M, 1)
            pos += 1
            if len(seq) < length and pos + allele[1] < len(ref):
                add(_D, allele[1])
                pos += allele[1]
    while cigar and cigar[-1][0] != _M:
        op, n = cigar.pop()
        if op == _I:
            del seq[-n:]
    return seq, cigar


def synthetic_longread_sample(
    seed: int,
    contig_lengths: Sequence[Tuple[str, int]] = (("chr1", 12000),
                                                 ("chr2", 5000)),
    depth: int = 20,
    mean_read_length: int = 3000,
    variant_spacing: int = 300,
    hp_tags: bool = True,
    sample_name: str = "synthetic_longread",
    cpg_snps: bool = False,
) -> dict:
    """The long-read form of `synthetic_sample`, in the same layout:
    single-end reads of a few kb from either strand over the same kind of
    reference and planted variants, with an error mix of indels (mostly
    in homopolymers) and substitutions, long soft clips, a few
    supplementary records and low-mapq reads, and, with `hp_tags`, an HP
    tag naming the read's true haplotype on most reads. The sample's
    `read_haps` holds every read's true haplotype (0 or 1). With
    `cpg_snps` every single-alt SNP becomes a C>T at a CpG (the
    reference there is rewritten to CG), the sites where methylation
    and a heterozygous variant meet; it draws nothing from the seed."""
    rng = np.random.RandomState(seed)
    reference = {}
    variants = {}
    rows = []
    serial = 0
    for ref_id, (name, length) in enumerate(contig_lengths):
        ref = _reference(rng, length)
        reference[name] = ref
        planted = _plant(rng, ref, variant_spacing)
        if cpg_snps:
            for v in planted:
                if len(v["alleles"]) == 1 and v["alleles"][0][0] == "snp":
                    ref[v["pos"]:v["pos"] + 2] = (ord("C"), ord("G"))
                    v["alleles"] = [("snp", "T")]
        variants[name] = planted
        by_pos = {v["pos"]: v for v in planted}
        n_reads = max(1, depth * length // mean_read_length)
        for _ in range(n_reads):
            want = int(np.clip(rng.normal(mean_read_length,
                                          mean_read_length / 4),
                               400, max(500, length - 50)))
            start = int(rng.randint(0, max(1, length - want // 2)))
            hap = int(rng.randint(2))
            seq, cigar = _long_read_from(
                rng, ref, by_pos, start, hap, want,
                sub_rate=0.002, ins_rate=0.004, del_rate=0.004)
            seq = np.array(seq, np.uint8)
            qual = rng.randint(20, 51, len(seq)).astype(np.uint8)
            low = rng.rand(len(seq)) < 0.02
            qual[low] = rng.randint(2, 10, int(low.sum()))
            pos = start
            if rng.rand() < 0.1 and cigar[0][1] > 30:
                k = min(int(rng.randint(20, 300)), cigar[0][1] - 10)
                cigar[0][1] -= k
                cigar.insert(0, [_S, k])
                seq[:k] = _BASES[rng.randint(0, 4, k)]
                pos += k
            if rng.rand() < 0.1 and cigar[-1][1] > 30:
                k = min(int(rng.randint(20, 300)), cigar[-1][1] - 10)
                cigar[-1][1] -= k
                cigar.append([_S, k])
                seq[-k:] = _BASES[rng.randint(0, 4, k)]
            flag = 0x10 if rng.rand() < 0.5 else 0
            if rng.rand() < 0.03:
                flag |= 0x800
            mapq = int(rng.randint(0, 5)) if rng.rand() < 0.05 else 60
            aux = b"RGZrg1\x00"
            if hp_tags and rng.rand() < 0.7:
                aux += b"HPC" + bytes([hap + 1])
            rows.append(dict(
                name=f"zmw{serial:06d}/ccs", flag=flag, ref_id=ref_id,
                pos=pos, mapq=mapq, seq=seq, qual=qual, cigar=cigar,
                mate_ref_id=-1, mate_pos=-1, tlen=0, aux=aux, hap=hap))
            serial += 1
    reads = _pack_reads(rows)  # sorts `rows` in place, as `read_haps`
    return dict(contigs=list(contig_lengths), reference=reference,
                variants=variants, reads=reads,
                read_haps=np.array([r["hap"] for r in rows], np.int8),
                sample_name=sample_name)


def _unpack_reads(reads: dict) -> List[dict]:
    """The packed columns of `_pack_reads` as read rows again."""
    so, co = reads["seq_offsets"], reads["cigar_offsets"]
    rows = []
    for i, name in enumerate(reads["name"]):
        rows.append(dict(
            name=name, flag=int(reads["flag"][i]),
            ref_id=int(reads["ref_id"][i]), pos=int(reads["pos"][i]),
            mapq=int(reads["mapq"][i]),
            seq=reads["seq"][so[i]:so[i + 1]].copy(),
            qual=reads["qual"][so[i]:so[i + 1]].copy(),
            cigar=[[int(op), int(n)] for op, n in zip(
                reads["cigar_ops"][co[i]:co[i + 1]],
                reads["cigar_lens"][co[i]:co[i + 1]])],
            mate_ref_id=int(reads["mate_ref_id"][i]),
            mate_pos=int(reads["mate_pos"][i]),
            tlen=int(reads["tlen"][i]), aux=reads["aux"][i]))
    return rows


def _aux_z(tag: bytes, text: bytes) -> bytes:
    return tag + b"Z" + text + b"\x00"


def _aux_b(tag: bytes, sub: bytes, values: np.ndarray) -> bytes:
    return tag + b"B" + sub + struct.pack("<I", len(values)) + \
        values.tobytes()


def _shift_indel_right(rng, row: dict, ref: np.ndarray) -> bool:
    """Rewrite one all-match read to carry a one-base deletion or
    insertion in a homopolymer of 3+ bases, written at the run's right
    end (where an aligner that does not left-align may put it); True if
    the read had such a run."""
    (op, n), = row["cigar"]
    start = row["pos"]
    span = ref[start:start + n]
    runs = [i for i in range(2, n - 12)
            if span[i] == span[i - 1] == span[i - 2] != span[i + 1]
            and span[i] != ord("N")
            and (row["seq"][i - 2:i + 1] == span[i]).all()]
    if not runs:
        return False
    last = runs[int(rng.randint(len(runs)))]
    if rng.rand() < 0.5:
        # Delete the run's last base: M(last) D1 M(rest).
        row["seq"] = np.delete(row["seq"], last)
        row["qual"] = np.delete(row["qual"], last)
        row["cigar"] = [[_M, last], [_D, 1], [_M, n - last - 1]]
    else:
        # One more copy of the run's base after its last base.
        row["seq"] = np.insert(row["seq"], last + 1, span[last])
        row["qual"] = np.insert(row["qual"], last + 1, row["qual"][last])
        row["cigar"] = [[_M, last + 1], [_I, 1], [_M, n - last - 1]]
    return True


def add_read_options(sample: dict, seed: int,
                     shifted_indels: int = 0) -> dict:
    """The sample with the short-read options' aux tags, drawn from
    `seed` only: an OQ tag on a third of the reads, differing from QUAL,
    a tenth of them one base short or long (those keep their QUAL);
    Ultima's tp (B:c, -1/0/1 per base, a few of the wrong length) and t0
    (Z, phred + 33) on most reads; and `shifted_indels` all-match reads
    rewritten to carry a one-base indel at the right end of a
    homopolymer. Returns a new sample."""
    rng = np.random.RandomState(seed)
    names = [n for n, _ in sample["contigs"]]
    rows = _unpack_reads(sample["reads"])
    plain = [i for i, r in enumerate(rows)
             if len(r["cigar"]) == 1 and r["cigar"][0][0] == _M]
    rng.shuffle(plain)
    shifted = 0
    for i in plain:
        if shifted == shifted_indels:
            break
        row = rows[i]
        shifted += _shift_indel_right(
            rng, row, sample["reference"][names[row["ref_id"]]])
    for row in rows:
        n = len(row["seq"])
        if rng.rand() < 0.33:
            quals = np.clip(row["qual"].astype(np.int64)
                            + rng.randint(-12, 13, n), 0, 60)
            if rng.rand() < 0.1:
                quals = quals[:-1] if rng.rand() < 0.5 else \
                    np.append(quals, 30)
            row["aux"] += _aux_z(b"OQ", (quals + 33).astype(
                np.uint8).tobytes())
        if rng.rand() < 0.8:
            tp = rng.choice(np.array([-1, 0, 0, 0, 0, 1], np.int8), n)
            if rng.rand() < 0.05:
                tp = tp[:-2]
            row["aux"] += _aux_b(b"tp", b"c", tp.astype(np.int8))
            t0 = rng.randint(0, 60, n) + 33
            row["aux"] += _aux_z(b"t0", t0.astype(np.uint8).tobytes())
    return dict(sample, reads=_pack_reads(rows))


def _mm_item(code: bytes, positions: List[int], marked: Dict[int, int],
             skip: bytes) -> Tuple[bytes, List[int]]:
    """One MM item over `positions` (the read offsets of the item's base
    in the original read's order) and its ML values: each delta counts
    the unmarked bases skipped before a marked one."""
    deltas, probs, skipped = [], [], 0
    for i in positions:
        if i in marked:
            deltas.append(skipped)
            probs.append(marked[i])
            skipped = 0
        else:
            skipped += 1
    text = code + skip + b"".join(b",%d" % d for d in deltas) + b";"
    return text, probs


def add_methylation(sample: dict, seed: int) -> dict:
    """The long-read sample with MM/ML tags, drawn from `seed` only.
    Every CpG gets a level per haplotype: at 40% of them
    (and at every C>T SNP of `cpg_snps`) one haplotype is methylated
    (ML 200-250) and the other not (5-40), at half the rest both are
    methylated, at the others neither. Forward reads carry the mark on
    the C, reverse reads on the G of the aligned sequence, as the
    original read's C; a few A's (T's on reverse reads) carry 6mA. Some
    reads spell the tags Mm/Ml, some use the '?' or '.' skip modes, and
    a tenth carry none. Returns a new sample."""
    rng = np.random.RandomState(seed)
    names = [n for n, _ in sample["contigs"]]
    levels = {}
    for name in names:
        ref = sample["reference"][name]
        snps = {v["pos"] for v in sample["variants"][name]
                if v["alleles"] == [("snp", "T")]}
        cpg = np.flatnonzero((ref[:-1] == ord("C")) & (ref[1:] == ord("G")))
        table = {}
        for p in cpg.tolist():
            u = rng.rand()
            if p in snps or u < 0.4:
                high = int(rng.randint(2))
                table[p] = (high, 1 - high)
            elif u < 0.7:
                table[p] = (1, 1)
            else:
                table[p] = (0, 0)
        levels[name] = table
    rows = _unpack_reads(sample["reads"])
    for row, hap in zip(rows, sample["read_haps"].tolist()):
        if rng.rand() < 0.1:
            continue
        table = levels[names[row["ref_id"]]]
        reverse = bool(row["flag"] & 0x10)
        seq = row["seq"]
        meth, m6a = {}, {}
        ref_i, read_i = row["pos"], 0
        for op, n in row["cigar"]:
            if op == _M:
                for k in range(n):
                    site = ref_i + k - (1 if reverse else 0)
                    base = seq[read_i + k]
                    if site in table and base == ord("G" if reverse
                                                     else "C"):
                        on = table[site][hap]
                        meth[read_i + k] = int(rng.randint(200, 251)) \
                            if on else int(rng.randint(5, 41))
                    elif base == ord("T" if reverse else "A") and \
                            rng.rand() < 0.05:
                        m6a[read_i + k] = int(rng.randint(1, 256))
                ref_i += n
                read_i += n
            elif op in (_I, _S):
                read_i += n
            elif op in (_D, _N):
                ref_i += n
        order = range(len(seq) - 1, -1, -1) if reverse else \
            range(len(seq))
        c_base, a_base = (ord("G"), ord("T")) if reverse else \
            (ord("C"), ord("A"))
        skip = (b"", b"?", b".")[int(rng.randint(3))]
        c_text, c_probs = _mm_item(
            b"C+m", [i for i in order if seq[i] == c_base], meth, skip)
        a_text, a_probs = _mm_item(
            b"A+a", [i for i in order if seq[i] == a_base], m6a, b"")
        mm_tag, ml_tag = (b"Mm", b"Ml") if rng.rand() < 0.2 else \
            (b"MM", b"ML")
        row["aux"] += _aux_z(mm_tag, c_text + a_text) + _aux_b(
            ml_tag, b"C", np.array(c_probs + a_probs, np.uint8))
    return dict(sample, reads=_pack_reads(rows))


def read_batch(sample: dict, bam_module):
    """The sample's reads as `bam_module.ReadBatch`."""
    batch = bam_module.ReadBatch([n for n, _ in sample["contigs"]])
    for key, value in sample["reads"].items():
        setattr(batch, key, list(value) if isinstance(value, list)
                else value.copy())
    return batch


def write_fasta(sample: dict, path: str, line_bases: int = 60) -> str:
    """Plain FASTA and its .fai."""
    fai = []
    with open(path, "wb") as f:
        for name, length in sample["contigs"]:
            f.write(b">" + name.encode() + b" synthetic\n")
            offset = f.tell()
            bases = sample["reference"][name].tobytes()
            for i in range(0, length, line_bases):
                f.write(bases[i:i + line_bases] + b"\n")
            fai.append(f"{name}\t{length}\t{offset}\t{line_bases}\t"
                       f"{line_bases + 1}\n")
    with open(path + ".fai", "w") as f:
        f.writelines(fai)
    return path


def bgzip_with_gzi(src: str, dst: str, bgzf_module,
                   block_bytes: int = 2000) -> str:
    """`src` as BGZF at `dst`, with `dst`.gzi (the offsets of every
    block after the first, as htslib's bgzip -i writes them) and a copy
    of `src`.fai."""
    with open(src, "rb") as f:
        data = f.read()
    with bgzf_module.BgzfWriter(dst) as w:
        # One small block per write, so that the file has many blocks.
        for i in range(0, len(data), block_bytes):
            w.write(data[i:i + block_bytes])
            w.flush()
    entries = []
    coff = uoff = 0
    with open(dst, "rb") as f:
        raw = f.read()
    while coff < len(raw):
        bsize = struct.unpack_from("<H", raw, coff + 16)[0] + 1
        isize = struct.unpack_from("<I", raw, coff + bsize - 4)[0]
        if coff and isize:
            entries.append((coff, uoff))
        coff += bsize
        uoff += isize
    with open(dst + ".gzi", "wb") as f:
        f.write(struct.pack("<Q", len(entries)))
        for c, u in entries:
            f.write(struct.pack("<QQ", c, u))
    with open(src + ".fai") as f, open(dst + ".fai", "w") as g:
        g.write(f.read())
    return dst


def write_inputs(sample: dict, directory: str, types_module, bam_module,
                 bam_writer_module) -> Dict[str, str]:
    """Write `ref.fa` (+ .fai) and the indexed `reads.bam` (+ .bai) with
    one package's writers; returns their paths."""
    os.makedirs(directory, exist_ok=True)
    ref_path = write_fasta(sample, os.path.join(directory, "ref.fa"))
    bam_path = os.path.join(directory, "reads.bam")
    contigs = [types_module.ContigInfo(n, length, i)
               for i, (n, length) in enumerate(sample["contigs"])]
    with bam_writer_module.BamWriter(
            bam_path, contigs, sample_name=sample["sample_name"]) as w:
        w.write_batch(read_batch(sample, bam_module))
    bam_writer_module.build_bam_index(bam_path)
    return dict(ref=ref_path, reads=bam_path)


def _vcf_alleles(ref: np.ndarray, v: dict) -> Tuple[str, List[str]]:
    """A planted variant as VCF (REF, [ALT, ...]): the reference bases
    span the longest deletion, and each alt is written against them."""
    pos = v["pos"]
    n = max([a[1] for a in v["alleles"] if a[0] == "del"], default=0)
    ref_bases = ref[pos:pos + 1 + n].tobytes().decode()
    alts = []
    for kind, x in v["alleles"]:
        if kind == "snp":
            alts.append(x + ref_bases[1:])
        elif kind == "ins":
            alts.append(ref_bases[0] + x + ref_bases[1:])
        else:
            alts.append(ref_bases[0] + ref_bases[1 + x:])
    return ref_bases, alts


def _other_alt(ref_bases: str, taken: Sequence[str]) -> str:
    """An alt at the site of `ref_bases` that is none of `taken`: a
    substitution of the first base if one is free, else an insertion."""
    options = [b + ref_bases[1:] for b in "ACGT"] + [
        ref_bases[0] + ins + ref_bases[1:] for ins in ("T", "GA")]
    return next(a for a in options if a != ref_bases and a not in taken)


def _population_records(rng, ref: np.ndarray, planted: List[dict]):
    """(start, REF, ALTs, AFs) of the cohort: every planted variant in one
    of five forms, so that every branch of the haplotype matching fires:
    the same alleles; the same haplotypes written one base longer; the
    true alts beside an extra alt; another alt at the same site (a
    REF-only match); or no record at all (the alts unmatched)."""
    out = []
    for v in planted:
        ref_bases, alts = _vcf_alleles(ref, v)
        form = int(rng.randint(5))
        afs = [float(np.round(rng.uniform(0.001, 0.3), 4)) for _ in alts]
        if form == 0:
            out.append((v["pos"], ref_bases, alts, afs))
        elif form == 1:
            tail = chr(ref[v["pos"] + len(ref_bases)])
            out.append((v["pos"], ref_bases + tail,
                        [a + tail for a in alts], afs))
        elif form == 2:
            out.append((v["pos"], ref_bases,
                        alts + [_other_alt(ref_bases, alts)],
                        afs + [0.0123]))
        elif form == 3:
            out.append((v["pos"], ref_bases,
                        [_other_alt(ref_bases, alts)], afs[:1]))
    return out


def write_vcf_inputs(sample: dict, directory: str, seed: int = 0,
                     population: bool = False,
                     population_by_contig: bool = False,
                     proposed: bool = False,
                     exclude: bool = False) -> Dict[str, object]:
    """Write the asked-for VCF inputs of stage 1 from the sample's planted
    variants, bgzipped (`.vcf.gz`) with a `.tbi`, and return their paths.

    - `population`: `population.vcf.gz`, the cohort of
      `_population_records` with an AF for every alt;
      `population_by_contig` writes the same records as one file per
      contig (`population.<contig>.vcf.gz`, a list under that key).
    - `proposed`: `proposed.vcf.gz`, the planted variants whose position
      lies in an even kilobase (so regions of an odd one hold none and
      the importer skips them), plus one reference site per contig that
      no read supports as a variant.
    - `exclude`: `exclude.vcf.gz`, planted variants with an AF of
      0.001, 0.05 or 0.5, or another alt at their site, or no record.

    The records come from `seed`, not from the sample's own draws, so
    every sample keeps its bytes."""
    from deepvariant_tpu_torch.core.types import ContigInfo, Variant
    from deepvariant_tpu_torch.io.tabix import build_index
    from deepvariant_tpu_torch.io.vcf import VcfHeader, VcfWriter

    os.makedirs(directory, exist_ok=True)
    contigs = [ContigInfo(n, length, i)
               for i, (n, length) in enumerate(sample["contigs"])]
    af_line = ("INFO", '<ID=AF,Number=A,Type=Float,'
               'Description="Allele frequency">')

    def write(name: str, records, with_af: bool) -> str:
        path = os.path.join(directory, name)
        header = VcfHeader(contigs, [], extras=[af_line] if with_af else [])
        with VcfWriter(path, header) as w:
            for contig, start, ref_bases, alts, afs in records:
                w.write(Variant(
                    reference_name=contig, start=start,
                    end=start + len(ref_bases), reference_bases=ref_bases,
                    alternate_bases=list(alts),
                    info={"AF": list(afs)} if with_af else {}))
        build_index(path)
        return path

    rng = np.random.RandomState(seed)
    cohort, proposals, excludes = [], [], []
    for name, _ in sample["contigs"]:
        ref = sample["reference"][name]
        planted = sample["variants"][name]
        cohort.extend((name,) + r
                      for r in _population_records(rng, ref, planted))
        site = [(v["pos"],) + _vcf_alleles(ref, v) for v in planted]
        free = next(p for p in range(150, len(ref), 7)
                    if chr(ref[p]) in "ACGT"
                    and all(abs(p - s[0]) > 20 for s in site)
                    and (p // 1000) % 2 == 0)
        chosen = [s for s in site if (s[0] // 1000) % 2 == 0]
        chosen.append((free, chr(ref[free]),
                       [_other_alt(chr(ref[free]), ())]))
        proposals.extend((name, p, r, a, []) for p, r, a in sorted(chosen))
        for pos, ref_bases, alts in site:
            form = int(rng.randint(5))
            if form < 3:
                excludes.append((name, pos, ref_bases, alts,
                                 [(0.001, 0.05, 0.5)[form]] * len(alts)))
            elif form == 3:
                excludes.append((name, pos, ref_bases,
                                 [_other_alt(ref_bases, alts)], [0.9]))
    out: Dict[str, object] = {}
    if population:
        out["population"] = write("population.vcf.gz", cohort, True)
    if population_by_contig:
        out["population_by_contig"] = [
            write(f"population.{name}.vcf.gz",
                  [r for r in cohort if r[0] == name], True)
            for name, _ in sample["contigs"]]
    if proposed:
        out["proposed"] = write("proposed.vcf.gz", proposals, False)
    if exclude:
        out["exclude"] = write("exclude.vcf.gz", excludes, True)
    return out


def _truth_genotype(v: dict) -> List[int]:
    if len(v["alleles"]) == 2:
        return [1, 2]
    return [0, 1] if len(v["haps"]) == 1 else [1, 1]


def write_truth_inputs(sample: dict, directory: str,
                       seed: int = 0) -> Dict[str, str]:
    """Write `truth.vcf.gz` (+ `.tbi`) and `confident.bed` for training
    mode and return their paths.

    The truth holds the planted variants with their genotypes and an
    INFO `type` (class1 for a SNP, class2 otherwise, for the customized
    classes labeler). A tenth of them, and one more per contig, are left
    out, so their candidates are false positives; one is written with a
    RefCall filter, which the labelers skip; and two SNPs per contig
    that no read carries are added 12 bases after planted variants, so
    the labelers see false negatives. The confident regions are each
    contig but one stretch that holds two planted variants. The choices
    come from `seed`, not from the sample's own draws."""
    from deepvariant_tpu_torch.core.types import (
        ContigInfo,
        Variant,
        VariantCall,
    )
    from deepvariant_tpu_torch.io.tabix import build_index
    from deepvariant_tpu_torch.io.vcf import VcfHeader, VcfWriter

    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(seed)
    contigs = [ContigInfo(n, length, i)
               for i, (n, length) in enumerate(sample["contigs"])]
    records = []
    bed = []
    filtered = False
    for name, length in sample["contigs"]:
        ref = sample["reference"][name]
        planted = sample["variants"][name]
        k = len(planted) // 3   # planted[k] and [k + 1]: not confident
        left_out = set(np.flatnonzero(rng.rand(len(planted)) < 0.1))
        left_out.add(int(rng.choice(
            [i for i in range(len(planted)) if i not in (k, k + 1)])))
        for i, v in enumerate(planted):
            if i in left_out:
                continue
            ref_bases, alts = _vcf_alleles(ref, v)
            kind = "class1" if all(a[0] == "snp" for a in v["alleles"]) \
                else "class2"
            flt = []
            if not filtered and len(v["alleles"]) == 1:
                flt, filtered = ["RefCall"], True
            records.append((name, v["pos"], ref_bases, alts,
                            _truth_genotype(v), kind, flt))
        # Beside a planted variant, so that the haplotype labeler groups
        # the unsupported record with a candidate and counts it.
        near = [v["pos"] + 12 for v in planted
                if chr(ref[v["pos"] + 12]) in "ACGT"]
        for p in sorted(rng.choice(near, 2, replace=False).tolist()):
            base = chr(ref[p])
            alt = "ACGT"[("ACGT".index(base) + 1) % 4]
            records.append((name, p, base, [alt], [0, 1], "class1", []))
        lo = planted[k]["pos"] - 5
        hi = planted[k + 1]["pos"] + 15
        bed += [(name, 0, lo), (name, hi, length)]
    records.sort(key=lambda r: ([n for n, _ in sample["contigs"]].index(
        r[0]), r[1]))
    path = os.path.join(directory, "truth.vcf.gz")
    header = VcfHeader(contigs, [sample["sample_name"]], extras=[(
        "INFO", '<ID=type,Number=1,Type=String,Description="Class">')])
    with VcfWriter(path, header) as w:
        for name, pos, ref_bases, alts, gt, kind, flt in records:
            w.write(Variant(
                reference_name=name, start=pos, end=pos + len(ref_bases),
                reference_bases=ref_bases, alternate_bases=list(alts),
                filter=flt, info={"type": [kind]},
                calls=[VariantCall(call_set_name=sample["sample_name"],
                                   genotype=gt)]))
    build_index(path)
    bed_path = os.path.join(directory, "confident.bed")
    with open(bed_path, "w") as f:
        f.writelines(f"{n}\t{a}\t{b}\n" for n, a, b in bed)
    return dict(truth=path, confident=bed_path)


# -- keras model stand-in ----------------------------------------------------

class _KerasLayer:
    """A layer with keras's interface as `convert_keras_inception` reads
    it: a `name` and `get_weights()`; the class name is keras's."""

    def __init__(self, name: str, weights: List[np.ndarray]):
        self.name = name
        self._weights = weights

    def get_weights(self) -> List[np.ndarray]:
        return list(self._weights)


def keras_inception_stand_in(seed: int, num_channels: int = 3,
                             head: bool = True):
    """A numpy stand-in of a keras InceptionV3 (backbone, and the dense
    head unless `head` is False), with seeded weights in keras's
    layouts: Conv2D [kernel (kh, kw, cin, cout)], BatchNormalization
    [beta, moving_mean, moving_variance] (scale=False), Dense [kernel,
    bias]. The layers are auto-named in creation order (conv2d,
    conv2d_1, ...) and listed as keras lists them, not in that order:
    the backbone is a nested Functional model, and its layers come
    shuffled. Returns the model object."""
    from deepvariant_tpu_torch.models.inception_v3 import (
        InceptionV3,
        to_flax_variables,
    )
    from deepvariant_tpu_torch.models.keras_import import FLAX_CONV_PATHS

    rng = np.random.RandomState(seed)
    params = to_flax_variables(InceptionV3(num_channels))["params"]
    classes = {}

    def layer(cls: str, name: str, weights):
        kind = classes.setdefault(cls, type(cls, (_KerasLayer,), {}))
        return kind(name, weights)

    def model(layers):
        kind = classes.setdefault("Functional", type("Functional", (), {}))
        out = kind()
        out.layers = layers
        out.name = "model"
        return out

    backbone = [layer("InputLayer", "input_1", [])]
    for i, path in enumerate(FLAX_CONV_PATHS):
        node = params
        for key in path:
            node = node[key]
        kernel_shape = node["conv"]["kernel"].shape
        fan_in = int(np.prod(kernel_shape[:-1]))
        suffix = f"_{i}" if i else ""
        cout = kernel_shape[-1]
        backbone.append(layer("Conv2D", f"conv2d{suffix}", [
            (rng.standard_normal(kernel_shape)
             * np.sqrt(2.0 / fan_in)).astype(np.float32)]))
        backbone.append(layer("BatchNormalization",
                              f"batch_normalization{suffix}", [
            (rng.standard_normal(cout) * 0.1).astype(np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, cout).astype(np.float32)]))
        backbone.append(layer("Activation", f"activation{suffix}", []))
    order = rng.permutation(len(backbone))
    layers = [model([backbone[i] for i in order])]
    if head:
        layers.append(layer("Dropout", "dropout", []))
        layers.append(layer("Dense", "dense", [
            (rng.standard_normal((2048, 3)) * 0.03).astype(np.float32),
            (rng.standard_normal(3) * 0.1).astype(np.float32)]))
    return model(layers)
