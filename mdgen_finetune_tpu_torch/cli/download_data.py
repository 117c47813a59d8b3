"""Fetch ATLAS MD trajectories for a split (reference
src/scripts/download_atlas.sh: per entry ``{name}_protein.zip`` from the
ATLAS database, unpacked into one directory per entry).

Counterpart of the JAX package's ``cli/download_data.py``:
- the standard library only (urllib, zipfile);
- resumable: an entry whose directory already holds files is skipped;
- ``--dry_run`` prints the URL plan and fetches nothing;
- ``file://`` base URLs read a local mirror.

    python -m mdgen_finetune_tpu_torch.cli.download_data --split splits/atlas.csv \\
        --outdir data/atlas [--base_url URL] [--dry_run]
"""
import argparse
import csv
import os
import sys
import tempfile
import urllib.error
import urllib.request
import zipfile

DEFAULT_BASE = "https://www.dsimb.inserm.fr/ATLAS/database/ATLAS"


def read_split_names(path):
    """Entry names from a split CSV with a ``name`` column."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if rows and "name" not in rows[0]:
        raise SystemExit(f"{path}: no 'name' column (header: {list(rows[0])})")
    return [r["name"] for r in rows]


def entry_url(base_url, name):
    """The reference's wget target: ``{base}/{name}/{name}_protein.zip``."""
    return f"{base_url.rstrip('/')}/{name}/{name}_protein.zip"


def fetch_entry(base_url, name, outdir):
    """Download and unpack one entry into ``outdir/name/``. Returns the entry
    directory, or None if it already held files (skipped)."""
    entry_dir = os.path.join(outdir, name)
    if os.path.isdir(entry_dir) and os.listdir(entry_dir):
        return None
    os.makedirs(outdir, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix=".zip", delete=False, dir=outdir) as tmp:
        tmp_path = tmp.name
    try:
        urllib.request.urlretrieve(entry_url(base_url, name), tmp_path)
        with zipfile.ZipFile(tmp_path) as zf:
            zf.extractall(entry_dir)
    finally:
        os.unlink(tmp_path)
    return entry_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--split", required=True, help="split CSV with a 'name' column")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--base_url", default=DEFAULT_BASE,
                    help="database root; file:// URLs read a local mirror")
    ap.add_argument("--dry_run", action="store_true",
                    help="print the URL plan, do not download")
    args = ap.parse_args(argv)
    names = read_split_names(args.split)
    if args.dry_run:
        for name in names:
            print(entry_url(args.base_url, name))
        print(f"# {len(names)} entries -> {args.outdir}", file=sys.stderr)
        return 0
    done = skipped = failed = 0
    for name in names:
        try:
            res = fetch_entry(args.base_url, name, args.outdir)
        except (urllib.error.URLError, OSError, zipfile.BadZipFile) as e:
            print(f"[fail] {name}: {e}", file=sys.stderr)
            failed += 1
            continue
        if res is None:
            skipped += 1
        else:
            done += 1
            print(f"[ok] {name}")
    print(f"downloaded {done}, skipped {skipped} (already present), failed {failed}",
          file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
