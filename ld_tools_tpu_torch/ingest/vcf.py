"""Streaming VCF parser for phased biallelic genotype tables.

Replaces the role pysam/htslib plays in the reference (random access +
record parsing, e.g. reference ld_lite.py:109-137).  The TPU-native design
does NOT need tabix random access at runtime: each chromosome's VCF is
scanned ONCE at ingest into a packed {0,1} haplotype matrix
(ld_tools_tpu/ingest/pack.py); all later queries hit the packed store.

Filtering semantics match reference backend/prep_intgen_data.py:163-176:

- only IDs matching ``^rs\\d+$`` are kept;
- records flagged ``MULTI_ALLELIC`` in INFO are dropped;
- consecutive runs of records with an identical (CHROM, POS, ID) triple
  (1000 Genomes encodes repeat-length variants as such sets) are dropped
  entirely.

A fast C++ scanner with the same contract lives in native/vcfpack.cpp
(bindings: ld_tools_tpu/ingest/native.py); this module is the portable
fallback and the semantics reference.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import re

import numpy as np

_RS_RE = re.compile(r"rs\d+$")


@dataclasses.dataclass
class VcfRecord:
    chrom: str
    pos: int
    rsid: str
    ref: str
    alts: tuple
    vt: tuple
    multiallelic: bool
    genotypes: np.ndarray  # (2 * n_samples,) int8, values {0, 1}
    # per-sample allele counts (n_samples,) uint8 in {1, 2}, or None when
    # every sample is diploid.  Haploid cells (1000G chrX non-PAR males,
    # all of chrY) store their single allele at column 2*i of
    # ``genotypes`` with column 2*i+1 zeroed; the reference appends the
    # raw GT tuple per sample instead (ld_area.py:230-235), which this
    # layout reproduces after dropping the dead columns in sample order.
    ploidy: np.ndarray = None


def open_vcf(path: str):
    """Open a .vcf or .vcf.gz as a text stream (multi-member/bgzf-safe)."""
    if str(path).endswith(".gz"):
        return io.TextIOWrapper(
            io.BufferedReader(gzip.open(path, "rb"), buffer_size=1 << 20),
            encoding="utf-8",
        )
    return open(path, "rt", encoding="utf-8")


def read_sample_names(path: str) -> list:
    """Sample names from the #CHROM header line, in column order."""
    with open_vcf(path) as fh:
        for line in fh:
            if line.startswith("#CHROM"):
                return line.rstrip("\n").split("\t")[9:]
            if not line.startswith("#"):
                break
    raise ValueError(f"{path}: no #CHROM header line")


def _parse_info(info_field: str):
    multiallelic = False
    vt = ()
    for item in info_field.split(";"):
        if item == "MULTI_ALLELIC":
            multiallelic = True
        elif item.startswith("VT="):
            vt = tuple(item[3:].split(","))
    return vt, multiallelic


_GT_DROP = frozenset((ord("|"), ord("/"), ord("\t"), ord("\n"), ord("\r")))


def _parse_genotypes(gt_section: str, n_samples: int):
    """Vectorized parse of a biallelic GT-only genotype section.

    Cells are ``a|b`` (diploid, phased or ``/``-separated) or a bare
    ``a`` (haploid — chrX non-PAR males, chrY).  Returns
    ``(genotypes, ploidy)``: genotypes is (2 * n_samples,) int8 with
    haploid cells at column 2*i and a zeroed column 2*i+1; ploidy is
    (n_samples,) uint8 in {1, 2}, or None when every cell is diploid.
    """
    raw = np.frombuffer(gt_section.encode("ascii"), dtype=np.uint8)
    if raw.size and raw[-1] == ord("\r"):
        raw = raw[:-1]
    tabs = np.flatnonzero(raw == ord("\t"))
    if tabs.size + 1 != n_samples:
        raise ValueError(
            f"expected {n_samples} genotype cells, found {tabs.size + 1}"
        )
    starts = np.empty(n_samples, dtype=np.int64)
    starts[0] = 0
    starts[1:] = tabs + 1
    ends = np.empty(n_samples, dtype=np.int64)
    ends[:-1] = tabs
    ends[-1] = raw.size
    lens = ends - starts
    diploid = lens == 3
    if not np.all(diploid | (lens == 1)):
        bad = int(np.flatnonzero(~(diploid | (lens == 1)))[0])
        cell = raw[starts[bad]:ends[bad]].tobytes().decode("ascii", "replace")
        raise ValueError(
            f"unsupported genotype cell {cell!r} (multiallelic or missing "
            "alleles are not supported)"
        )
    a1 = raw[starts] - ord("0")
    # second-allele byte for diploid cells; haploid cells read their own
    # first byte (discarded below), keeping the gather in-bounds
    a2 = raw[np.where(diploid, starts + 2, starts)] - ord("0")
    a2 = np.where(diploid, a2, 0)
    seps = raw[np.where(diploid, starts + 1, starts)]
    bad_sep = diploid & (seps != ord("|")) & (seps != ord("/"))
    # allele bytes are uint8: '.' and other non-digits wrap past 1
    if bad_sep.any() or (a1 > 1).any() or (a2 > 1).any():
        raise ValueError(
            "non-biallelic or missing allele codes in GT section"
        )
    out = np.empty(2 * n_samples, dtype=np.int8)
    out[0::2] = a1
    out[1::2] = a2
    if diploid.all():
        return out, None
    return out, np.where(diploid, 2, 1).astype(np.uint8)


def iter_records(path: str, with_genotypes: bool = True):
    """Yield filtered VcfRecords; handles the duplicate-triple run rule.

    Records are yielded with one-record delay so that a consecutive run
    of identical (CHROM, POS, ID) triples AMONG THE KEPT RECORDS can be
    suppressed entirely — the reference applies its rs-ID and
    MULTI_ALLELIC filters BEFORE the duplicate comparison
    (backend/prep_intgen_data.py:165-175: ``continue`` precedes the
    prev-triple check), so a filtered record between two identical
    triples does not break the run, and a filtered duplicate does not
    mark one.  This parser and the native scanner implement the same
    order.
    """
    sample_names = read_sample_names(path)
    n_samples = len(sample_names)
    pending = None  # last accepted-but-unemitted record
    pending_dup = False
    with open_vcf(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t", 9)
            chrom, pos_s, rsid, ref, alt = fields[:5]
            if _RS_RE.match(rsid) is None:
                continue
            vt, multiallelic = _parse_info(fields[7])
            if multiallelic:
                continue
            pos = int(pos_s)
            key = (chrom, pos, rsid)
            if pending is not None and key == (
                pending.chrom,
                pending.pos,
                pending.rsid,
            ):
                pending_dup = True
                continue
            if pending is not None and not pending_dup:
                yield pending
            gts = ploidy = None
            if with_genotypes:
                fmt = fields[8]
                if fmt.split(":", 1)[0] != "GT":
                    raise ValueError(f"{path}: FORMAT must lead with GT, got {fmt}")
                if fmt == "GT":
                    gts, ploidy = _parse_genotypes(fields[9], n_samples)
                else:
                    # rare general case: per-sample fields carry extras
                    gt_first = "\t".join(
                        f.split(":", 1)[0] for f in fields[9].split("\t")
                    )
                    gts, ploidy = _parse_genotypes(gt_first, n_samples)
            pending = VcfRecord(
                chrom=chrom,
                pos=pos,
                rsid=rsid,
                ref=ref,
                alts=tuple(alt.split(",")),
                vt=vt,
                multiallelic=multiallelic,
                genotypes=gts,
                ploidy=ploidy,
            )
            pending_dup = False
    if pending is not None and not pending_dup:
        yield pending
