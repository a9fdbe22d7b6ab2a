"""HaplotypeStore: runtime access to the packed per-chromosome arrays.

The query surface the three workloads need (SURVEY.md §3):

- rsID -> row (reference: SQLite ``variants`` lookups, ld_lite.py:41);
- position window -> row range (reference: tabix ``fetch(chrom, lo, hi)``,
  ld_area.py:215-217) — positions are sorted, so this is a searchsorted;
- cohort -> haplotype column indices (reference: per-record dict lookups
  over sample names, ld_area.py:230-235).
"""

from __future__ import annotations

import threading

import numpy as np

from ld_tools_tpu_torch.ingest import pack


class ChromData:
    """One chromosome's packed haplotype matrix + sidecars, lazily unpacked.

    Lazy loads are lock-guarded so concurrent tool workers (tools/common.
    map_files) never unpack the same matrix twice.
    """

    def __init__(self, intgen_dir_path: str, chrom: str):
        self.chrom = chrom
        self._dir = intgen_dir_path
        self._lock = threading.Lock()
        if not pack.is_packed(intgen_dir_path, chrom):
            raise FileNotFoundError(
                f"chromosome {chrom} is not packed under "
                f"{pack.store_root(intgen_dir_path)}; place {chrom}.vcf.gz "
                f"in {intgen_dir_path} and run the prep stage (any tool "
                "without -f, or scripts/prep_data.py)"
            )
        meta = pack.read_meta(intgen_dir_path, chrom)
        self.n_variants = meta["n_variants"]
        self.n_haplotypes = meta["n_haplotypes"]
        self.samples = meta["samples"]
        # (P, n_samples) per-sample allele counts per ploidy profile, or
        # None when every variant is diploid (autosomes); profile ids per
        # variant live in the pgroup sidecar (chrX/chrY,
        # reference ld_area.py:230-235 ploidy-agnostic gather)
        profs = meta.get("ploidy_profiles")
        self.ploidy_profiles = (
            None if profs is None else np.asarray(profs, dtype=np.uint8)
        )
        self.pos = pack.read_sidecar(intgen_dir_path, chrom, "pos")
        self._rsid = None
        self._G = None
        self._packed = None
        self._row_index = None
        self._pgroup = None
        self._ann = {}

    @property
    def rsid(self) -> np.ndarray:
        if self._rsid is None:
            with self._lock:
                if self._rsid is None:
                    self._rsid = pack.read_sidecar(
                        self._dir, self.chrom, "rsid"
                    )
        return self._rsid

    @property
    def genotypes(self) -> np.ndarray:
        """(V, H) int8 {0,1}; unpacked once and cached."""
        if self._G is None:
            with self._lock:
                if self._G is None:
                    self._G = pack.read_genotypes(
                        self._dir, self.chrom, self.n_haplotypes
                    )
        return self._G

    def genotype_rows(self, rows) -> np.ndarray:
        """(len(rows), H) int8 for selected variants only.

        Unpacks just the requested rows from the bitpacked file — point
        queries (ld_lite) and small matrices stay O(rows), not O(V).
        Uses the cached full matrix when it is already resident.
        """
        rows = np.asarray(rows, dtype=np.int64)
        if self._G is not None:
            return self._G[rows]
        return pack.unpack_rows(self.packed, rows, self.n_haplotypes)

    @property
    def packed(self) -> np.ndarray:
        """(V, ceil(H/8)) uint8 bitpacked matrix, memory-mapped."""
        if self._packed is None:
            with self._lock:
                if self._packed is None:
                    self._packed = pack.read_packed(self._dir, self.chrom)
        return self._packed

    def annotation(self, name: str) -> np.ndarray:
        """'ref' | 'alt' | 'vt' sidecar."""
        if name not in self._ann:
            with self._lock:
                if name not in self._ann:
                    self._ann[name] = pack.read_sidecar(
                        self._dir, self.chrom, name
                    )
        return self._ann[name]

    def row_of(self, rsid: str):
        """Row index of an rsID, or None (first match wins, like the
        reference's ``cursor.fetchone()`` on the ID index, ld_lite.py:41-42)."""
        if self._row_index is None:
            idx = {}
            for i, rid in enumerate(self.rsid):
                idx.setdefault(rid, i)
            self._row_index = idx  # atomic publish; rebuild race is benign
        return self._row_index.get(rsid)

    def row_at(self, rsid: str, pos: int):
        """Row of an rsID at a SPECIFIC position.

        conversion.db can hold one rsID at two positions (ingest drops
        only consecutive duplicate triples); ``row_of`` alone would
        collapse both queries onto the first row.  Falls back to
        ``row_of`` when nothing matches at ``pos`` (the reference's
        recorded-position fetch + rsID match, ld_area.py:153-159).
        """
        r = self.row_of(rsid)
        if r is not None and int(self.pos[r]) == int(pos):
            return r
        lo = int(np.searchsorted(self.pos, pos, side="left"))
        hi = int(np.searchsorted(self.pos, pos, side="right"))
        for k in range(lo, hi):
            if str(self.rsid[k]) == rsid:
                return k
        return r

    def window(self, low_bound: int, high_bound: int):
        """Row range [start, stop) with low_bound < pos <= high_bound.

        Matches pysam/tabix fetch(chrom, low, high) half-open 0-based
        semantics on 1-based VCF positions (reference ld_area.py:215-217)
        for every variant STARTING inside the window.  Known divergence
        (docs/PARITY.md): a deletion whose REF allele starts at or
        before ``low_bound`` but spans past it is returned by tabix
        (interval overlap) yet excluded here (start-position match) —
        only indels whose REF crosses the window's left edge differ.
        """
        start = int(np.searchsorted(self.pos, low_bound, side="right"))
        stop = int(np.searchsorted(self.pos, high_bound, side="right"))
        return start, stop

    @property
    def pgroup(self) -> np.ndarray:
        """(V,) int16 ploidy-profile id per variant (zeros if uniform)."""
        if self._pgroup is None:
            with self._lock:
                if self._pgroup is None:
                    if self.ploidy_profiles is None:
                        self._pgroup = np.zeros(
                            self.n_variants, dtype=np.int16
                        )
                    else:
                        self._pgroup = pack.read_sidecar(
                            self._dir, self.chrom, "pgroup"
                        )
        return self._pgroup

    def cohort_ploidy(self, sample_names) -> "CohortPloidy":
        """Cohort selection resolved against the ploidy profiles."""
        return CohortPloidy(self, sample_names)

    def haplotype_columns(self, sample_names) -> np.ndarray:
        """Column indices for a cohort: (2i, 2i+1) per present sample.

        Samples absent from the VCF are silently skipped, mirroring the
        reference's per-record KeyError pass (ld_area.py:233-235).
        """
        col_of = {name: i for i, name in enumerate(self.samples)}
        cols = []
        for name in sample_names:
            i = col_of.get(name)
            if i is not None:
                cols.append(2 * i)
                cols.append(2 * i + 1)
        return np.asarray(cols, dtype=np.int64)

    def cohort_genotypes(self, sample_names) -> np.ndarray:
        """(V, 2 * n_present_samples) int8 for the cohort."""
        return self.genotypes[:, self.haplotype_columns(sample_names)]


class CohortPloidy:
    """Cohort column layout per ploidy profile.

    The reference builds each variant's genotype list by appending
    ``rec.samples[s]['GT']`` per cohort sample (ld_area.py:230-235) —
    2 alleles for a diploid cell, 1 for a haploid one.  In the packed
    store's full layout (sample i at columns 2i, 2i+1; haploid cells
    zero-fill 2i+1), that list equals the row sliced at this class's
    ``cols_for(profile)`` — the cohort's live columns in sample order —
    so LD between same-profile variants is a matmul over those columns
    and cross-profile pairs truncate to the shorter layout's prefix
    (calc_ld.py:30-33 zip semantics).
    """

    def __init__(self, chrom_data: ChromData, sample_names):
        self._cd = chrom_data
        col_of = {name: i for i, name in enumerate(chrom_data.samples)}
        idx = []
        for name in sample_names:
            i = col_of.get(name)
            if i is not None:
                idx.append(i)
        if sample_names and not idx:
            # the selection matched the samples table but NOT this
            # chromosome's VCF (e.g. -g female against a male-only chrY
            # store): the reference crashes later with ZeroDivisionError
            # in calc_ld (htypes_quan == 0); computing on would emit a
            # table of NaNs presented as a valid answer
            raise ValueError(
                f"none of the {len(sample_names)} selected samples are "
                f"present in chr{chrom_data.chrom}'s store; check "
                "-g/-e against this chromosome's sample set"
            )
        self.sample_idx = np.asarray(idx, dtype=np.int64)
        self._cols = {}

    @property
    def trivial(self) -> bool:
        """True when every variant of the chromosome is all-diploid."""
        return self._cd.ploidy_profiles is None

    def groups_of(self, rows) -> np.ndarray:
        if self.trivial:
            return np.zeros(np.asarray(rows).shape[0], dtype=np.int16)
        return np.asarray(self._cd.pgroup)[np.asarray(rows)]

    def cols_for(self, gid: int) -> np.ndarray:
        """Live haplotype columns of profile ``gid`` for this cohort,
        in the reference's append order (sample-major, hapA then hapB)."""
        gid = int(gid)
        if gid not in self._cols:
            if self.trivial:
                ploidy = np.full(self.sample_idx.shape[0], 2, dtype=np.uint8)
            else:
                ploidy = self._cd.ploidy_profiles[gid][self.sample_idx]
            cols = []
            for i, s in enumerate(self.sample_idx):
                cols.append(2 * int(s))
                if ploidy[i] == 2:
                    cols.append(2 * int(s) + 1)
            self._cols[gid] = np.asarray(cols, dtype=np.int64)
        return self._cols[gid]

    def n_alleles(self, gid: int) -> int:
        """Reference genotype-list length for a profile-``gid`` variant."""
        return int(self.cols_for(gid).shape[0])


class HaplotypeStore:
    """All packed chromosomes under one 1000G data directory."""

    def __init__(self, intgen_dir_path: str):
        self.intgen_dir_path = intgen_dir_path
        self._chroms = {}
        self._lock = threading.Lock()

    def chroms(self) -> list:
        return pack.list_chroms(self.intgen_dir_path)

    def chrom(self, chrom: str) -> ChromData:
        # locked check-then-act: tool workers are THREADS sharing one
        # store (tools/common.map_files); two racing constructions would
        # each cache (and later unpack) their own copy of the matrix
        with self._lock:
            if chrom not in self._chroms:
                self._chroms[chrom] = ChromData(
                    self.intgen_dir_path, chrom
                )
            return self._chroms[chrom]
