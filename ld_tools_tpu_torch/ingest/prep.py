"""One-time, idempotent, resumable data bootstrap.

TPU-native equivalent of reference backend/prep_intgen_data.py:6-190.
Stages (each guarded by an artifact-existence check, so the whole function
is rerunnable — reference :30, :83, :123, :136, :147):

1. ``samples.txt``   download the 1000G sample panel if absent; validate
                     its header structure.
2. ``conversion.db`` SQLite with the reference-compatible ``samples`` and
                     ``variants`` tables (cohort SQL + rsID resolution).
3. per-chromosome    download the VCF if absent (retrying), then scan it
                     ONCE into the packed haplotype store
                     (ingest/pack.py) — this replaces both the reference's
                     tabix indexing and its separate variants-table scan:
                     the variants table is filled from the packed sidecars.
4. index ``variants(ID)``.

Offline-first: if the panel and VCFs are already on disk (or the packed
store already exists), no network is touched — the reference's own FTP
source is dead (reference README.md:2), so offline operation is the normal
mode, with synthetic data generators (ingest/synth.py) for testing.
"""

from __future__ import annotations

import os
import re
import sqlite3
import time
import urllib.request

import numpy as np

from ld_tools_tpu_torch.ingest import pack
from ld_tools_tpu_torch.utils.logging import Counters, get_logger

log = get_logger("ingest.prep")
counters = Counters()

PANEL_URL = (
    "ftp://ftp.1000genomes.ebi.ac.uk/vol1/ftp/release/20130502/"
    "integrated_call_samples_v3.20130502.ALL.panel"
)
HG38_INDEX_URL = (
    "ftp://ftp.1000genomes.ebi.ac.uk/vol1/ftp/release/20130502/"
    "supporting/GRCh38_positions/"
)
PANEL_HEADER = ["sample", "pop", "super_pop", "gender"]
_CHR_FROM_NAME = re.compile(r"(?:\A|[^\w])chr(\d{1,2}|X|Y)", re.IGNORECASE)


class PanelStructureError(RuntimeError):
    """samples.txt no longer has the expected column structure.

    (The reference aborts here via an un-imported ``sys`` —
    prep_intgen_data.py:57 — one of the quirks not replicated.)
    """


def _download(url: str, path: str, retries: int = 3, retry_delay_s: int = 60):
    """Download with bounded retries and partial-file cleanup.

    The reference retries forever at 60 s intervals
    (prep_intgen_data.py:124-133); bounded retries fail fast in the
    zero-egress environments this framework typically runs in.
    """
    tmp = path + ".part"
    for attempt in range(retries):
        try:
            # download to a temp name and publish atomically: a SIGKILL
            # or Ctrl-C mid-transfer must never leave a truncated file
            # at the final path (later runs would treat it as complete
            # and silently build smaller cohorts)
            urllib.request.urlretrieve(url, tmp)
            os.replace(tmp, path)
            return
        except Exception as exc:  # noqa: BLE001 - mirror reference's bare except
            if os.path.exists(tmp):
                os.remove(tmp)
            log.warning("download failed (%s): %s", url, exc)
            if attempt + 1 < retries:
                time.sleep(retry_delay_s)
    raise RuntimeError(
        f"could not download {url}; place the file at {path} manually "
        "for offline operation"
    )


def _ensure_panel(intgen_dir_path: str) -> str:
    path = os.path.join(intgen_dir_path, "samples.txt")
    if not os.path.exists(path):
        log.info("samples.txt missing; downloading panel")
        _download(PANEL_URL, path)
    return path


def _load_panel(path: str):
    with open(path) as fh:
        header = fh.readline().rstrip().split("\t")
        if header != PANEL_HEADER:
            raise PanelStructureError(
                f"samples.txt header {header} != expected {PANEL_HEADER}"
            )
        return [line.rstrip().split("\t") for line in fh if line.strip()]


def _ensure_samples_table(cursor, conn, panel_rows):
    cursor.execute(
        "CREATE TABLE IF NOT EXISTS samples (sample, pop, super_pop, gender)"
    )
    cursor.execute("SELECT * FROM samples LIMIT 1")
    if cursor.fetchone() is None:
        cursor.executemany(
            "INSERT INTO samples VALUES (?, ?, ?, ?)", panel_rows
        )
        conn.commit()


def discover_vcfs(intgen_dir_path: str) -> dict:
    """{chrom: vcf_path} for per-chromosome VCFs already on disk.

    Accepts the reference's ``<chrom>.vcf.gz`` naming
    (prep_intgen_data.py:121-122) plus plain ``.vcf`` and ``chrN``-embedded
    names.
    """
    out = {}
    for name in sorted(os.listdir(intgen_dir_path)):
        if not (name.endswith(".vcf.gz") or name.endswith(".vcf")):
            continue
        stem = name[: -len(".vcf.gz")] if name.endswith(".vcf.gz") else name[:-4]
        if re.fullmatch(r"\d{1,2}|X|Y", stem, flags=re.IGNORECASE):
            out[stem.upper()] = os.path.join(intgen_dir_path, name)
            continue
        m = _CHR_FROM_NAME.search(stem)
        if m:
            # normalize x/y to the reference's uppercase naming so the
            # store directory and the variants table never disagree
            out.setdefault(
                m.group(1).upper(), os.path.join(intgen_dir_path, name)
            )
    return out


def _pack_chromosome(vcf_path: str, intgen_dir_path: str, chrom: str):
    """Scan one VCF into the packed store (native scanner if available)."""
    from ld_tools_tpu_torch.ingest import native

    t0 = time.time()
    result = native.scan_vcf_packed(vcf_path)
    if result is not None:
        (packed, n_hap, pos, rsid, ref, alt, vt, samples,
         pgroup, profiles) = result
    else:
        from ld_tools_tpu_torch.ingest import vcf as vcf_mod

        samples = vcf_mod.read_sample_names(vcf_path)
        n_hap = 2 * len(samples)
        # rows are packed as they stream so chromosome-scale ingest
        # holds ~626 B/variant, never the unpacked matrix
        gt_rows, pos_l, rsid_l, ref_l, alt_l, vt_l = [], [], [], [], [], []
        # ploidy profiles interned by per-sample allele-count vector;
        # profile 0 is always the all-diploid one (chrX PAR / autosomes)
        profile_ids = {b"": 0}
        profile_rows = [np.full(len(samples), 2, dtype=np.uint8)]
        pgroup_l = []
        for rec in vcf_mod.iter_records(vcf_path):
            gt_rows.append(np.packbits(rec.genotypes))
            pos_l.append(rec.pos)
            rsid_l.append(rec.rsid)
            ref_l.append(rec.ref)
            alt_l.append(",".join(rec.alts))
            vt_l.append(",".join(rec.vt))
            key = b"" if rec.ploidy is None else rec.ploidy.tobytes()
            gid = profile_ids.get(key)
            if gid is None:
                gid = len(profile_rows)
                profile_ids[key] = gid
                profile_rows.append(rec.ploidy.copy())
            pgroup_l.append(gid)
        if gt_rows:
            packed = np.vstack(gt_rows)
        else:
            packed = np.zeros((0, (n_hap + 7) // 8), dtype=np.uint8)
        pos, rsid, ref, alt, vt = pos_l, rsid_l, ref_l, alt_l, vt_l
        if len(profile_rows) > 1:
            pgroup = np.asarray(pgroup_l, dtype=np.int16)
            profiles = np.stack(profile_rows)
        else:
            pgroup = profiles = None
    pack.write_chrom(
        intgen_dir_path, chrom, pos=pos, rsid=rsid, ref=ref, alt=alt,
        vt=vt, samples=samples, genotypes_packed=packed,
        n_haplotypes=n_hap, pgroup=pgroup, ploidy_profiles=profiles,
    )
    counters.add("variants_ingested", len(pos))
    counters.add("chromosomes_packed")
    log.info(
        "packed chr%s: %d variants x %d haplotypes in %.1fs (%.0f variants/s)",
        chrom,
        len(pos),
        n_hap,
        time.time() - t0,
        len(pos) / max(time.time() - t0, 1e-9),
    )


def _ensure_variants_rows(cursor, conn, intgen_dir_path: str, chrom: str):
    cursor.execute(
        "CREATE TABLE IF NOT EXISTS variants (CHROM TEXT, POS INTEGER, ID TEXT)"
    )
    cursor.execute("SELECT 1 FROM variants WHERE CHROM = ? LIMIT 1", (chrom,))
    if cursor.fetchone() is not None:
        return
    pos = pack.read_sidecar(intgen_dir_path, chrom, "pos")
    rsid = pack.read_sidecar(intgen_dir_path, chrom, "rsid")
    cursor.executemany(
        "INSERT INTO variants VALUES (?, ?, ?)",
        ((chrom, int(p), str(r)) for p, r in zip(pos, rsid)),
    )
    conn.commit()


def _maybe_download_vcfs(intgen_dir_path: str) -> dict:
    """Reference's urls.txt flow, used only when no VCFs are local."""
    urls_path = os.path.join(intgen_dir_path, "urls.txt")
    if not os.path.exists(urls_path):
        log.info("urls.txt missing; scraping FTP index (requires network)")
        with urllib.request.urlopen(HG38_INDEX_URL) as response:
            names = re.findall(
                r"ALL\.chr(?:\d{1,2}|X|Y)_GRCh38\.genotypes\.\S+?\.vcf\.gz"
                r"(?=\r?\n)",
                response.read().decode("UTF-8"),
            )
        if not names:
            # writing an empty urls.txt would make every future run
            # silently succeed with zero chromosomes
            raise RuntimeError(
                "FTP index scrape matched no per-chromosome VCF names; "
                "place urls.txt (one URL per line) or the .vcf.gz files "
                "in the data directory manually"
            )
        with open(urls_path, "w") as fh:
            for name in names:
                fh.write(HG38_INDEX_URL + name + "\n")
    out = {}
    with open(urls_path) as fh:
        for line in fh:
            url = line.strip()
            if not url:
                continue
            m = re.search(
                r"(?<=chr)(?:\d{1,2}|X|Y)", os.path.basename(url),
                flags=re.IGNORECASE,
            )
            if m is None:
                raise RuntimeError(
                    f"cannot infer a chromosome from urls.txt line: {url}"
                )
            chrom = m.group().upper()
            vcf_path = os.path.join(intgen_dir_path, f"{chrom}.vcf.gz")
            if not os.path.exists(vcf_path):
                _download(url, vcf_path)
            out[chrom] = vcf_path
    return out


def prep_intgen_data(intgen_dir_path: str) -> str:
    """Bootstrap the data directory; returns the conversion.db path."""
    os.makedirs(intgen_dir_path, exist_ok=True)
    panel_path = _ensure_panel(intgen_dir_path)
    panel_rows = _load_panel(panel_path)

    intgen_convdb_path = os.path.join(intgen_dir_path, "conversion.db")
    conn = sqlite3.connect(intgen_convdb_path)
    cursor = conn.cursor()
    try:
        _ensure_samples_table(cursor, conn, panel_rows)

        vcfs = discover_vcfs(intgen_dir_path)
        if not vcfs and not pack.list_chroms(intgen_dir_path):
            vcfs = _maybe_download_vcfs(intgen_dir_path)
        for chrom, vcf_path in vcfs.items():
            if not pack.is_packed(intgen_dir_path, chrom):
                _pack_chromosome(vcf_path, intgen_dir_path, chrom)
        for chrom in pack.list_chroms(intgen_dir_path):
            _ensure_variants_rows(cursor, conn, intgen_dir_path, chrom)

        cursor.execute('CREATE INDEX IF NOT EXISTS "id" ON variants (ID)')
        conn.commit()
    finally:
        cursor.close()
        conn.close()
    return intgen_convdb_path
