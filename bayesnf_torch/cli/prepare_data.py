"""Download + verify the paper's 6 spatiotemporal datasets (counterpart of
`bayesnf_tpu/cli/prepare_data.py`, a copy on the port's registry).

The reference's experiments read ``{dataset}.{series}.{train,test}.csv``
files from a data root (reference ``scripts/README:12-41``); the datasets
are published at Zenodo, DOI ``10.5281/zenodo.12735404`` (the same archive
also carries every method's predictions). This script fetches that archive
where network access exists, unpacks it, and verifies the layout against
the dataset registry so the CLI (`bayesnf_torch.cli.evaluate`), the
tutorials, and the PARITY comparisons can run on the real data:

    python -m bayesnf_torch.cli.prepare_data --dest datasets/
    python -m bayesnf_torch.cli.evaluate --dataset=chickenpox \
        --data_root datasets/ --output_dir out/ --start_id 5 --stop_id 6

Offline environments: download ``datasets.zip`` elsewhere, then run with
``--archive /path/to/datasets.zip`` to unpack + verify without network.
`--verify-only` checks an existing data root and exits non-zero listing
anything missing.
"""

import argparse
import csv
import hashlib
import os
import sys
import zipfile

from bayesnf_torch.cli import registry

ZENODO_RECORD = '12735404'
ZENODO_URL = (
    f'https://zenodo.org/api/records/{ZENODO_RECORD}/files/datasets.zip/content'
)
DOI = '10.5281/zenodo.12735404'


def expected_files(dataset: str) -> list[str]:
  """The train/test CSV names the registry says this dataset comprises."""
  cfg = registry.dataset_config(dataset)
  names = []
  for series in range(cfg['num_series']):
    sid = cfg['series_id_fmt'](series)
    names.append(f'{dataset}.{sid}.train.csv')
    names.append(f'{dataset}.{sid}.test.csv')
  return names


def verify_layout(
    data_root: str, datasets=None, deep: bool = False
) -> dict[str, list[str]]:
  """{dataset: [problems]} for the requested (default: all) datasets.

  A problem is a missing file, or — with `deep` — an empty file or one
  whose header lacks the registry's feature/target columns (catches a
  wrong or truncated archive before a long fit does).
  """
  problems = {}
  for dataset in datasets or registry.runnable_datasets():
    cfg = registry.dataset_config(dataset)
    want_cols = set(cfg['feature_cols']) | {cfg['target_col']}
    bad = []
    for name in expected_files(dataset):
      path = os.path.join(data_root, name)
      if not os.path.exists(path):
        bad.append(f'{name}: missing')
        continue
      if not deep:
        continue
      if os.path.getsize(path) == 0:
        bad.append(f'{name}: empty file')
        continue
      with open(path, 'r', encoding='utf-8', errors='replace', newline='') as f:
        try:
          fields = next(csv.reader(f))
        except StopIteration:
          fields = []
      # Exact field-name comparison (not substring-in-line: a short column
      # name like 'sst' appearing inside unrelated header text must not
      # pass the check).
      header_cols = {c.strip() for c in fields}
      absent_cols = sorted(want_cols - header_cols)
      if absent_cols:
        bad.append(f'{name}: header lacks column(s) {absent_cols}')
    if bad:
      problems[dataset] = bad
  return problems


def record_archive_checksum() -> str | None:
  """The Zenodo record's published checksum for datasets.zip, or None.

  Queried from the record API at download time (needs network); any
  failure degrades to None — the checksum is a defense, not a gate.
  Zenodo checksums are 'md5:<hex>'.
  """
  import json
  import urllib.request

  try:
    with urllib.request.urlopen(  # noqa: S310
        f'https://zenodo.org/api/records/{ZENODO_RECORD}', timeout=30
    ) as resp:
      record = json.load(resp)
    for entry in record.get('files', []):
      if entry.get('key') == 'datasets.zip':
        return entry.get('checksum')
  except Exception as err:  # pylint: disable=broad-except
    print(f'note: could not fetch record metadata for checksum ({err})')
  return None


def file_md5(path: str) -> str:
  h = hashlib.md5()
  with open(path, 'rb') as f:
    for block in iter(lambda: f.read(1 << 20), b''):
      h.update(block)
  return h.hexdigest()


def download(dest_zip: str) -> None:
  """Fetch datasets.zip from Zenodo (needs network access) and verify its
  md5 against the record's published checksum when that is retrievable."""
  import urllib.request

  print(f'downloading {ZENODO_URL} (DOI {DOI}) -> {dest_zip}')
  try:
    urllib.request.urlretrieve(ZENODO_URL, dest_zip)  # noqa: S310
  except Exception as err:
    raise SystemExit(
        f'download failed ({err}). If this machine has no network access, '
        f'fetch datasets.zip from DOI {DOI} elsewhere and re-run with '
        f'--archive /path/to/datasets.zip.'
    ) from err
  want = record_archive_checksum()
  if want and want.startswith('md5:'):
    got = file_md5(dest_zip)
    if got != want[4:]:
      raise SystemExit(
          f'checksum mismatch for {dest_zip}: record says {want}, got '
          f'md5:{got} — corrupt or truncated download; delete and retry.'
      )
    print(f'checksum ok ({want})')


def unpack(archive: str, dest: str, flatten_known: bool = True) -> None:
  """Unzip onto `dest`, flattening any single top-level directory.

  `flatten_known` additionally recognizes expected dataset CSVs by
  BASENAME anywhere in the archive tree and places them directly at the
  `dest` root — tolerating archive layouts that nest the CSVs deeper
  than one directory (the evaluate CLI reads them flat from data_root,
  reference scripts/README:12-41).
  """
  known = set()
  if flatten_known:
    for dataset in registry.runnable_datasets():
      known.update(expected_files(dataset))
  os.makedirs(dest, exist_ok=True)
  with zipfile.ZipFile(archive) as zf:
    names = [n for n in zf.namelist() if not n.endswith('/')]
    roots = {n.split('/', 1)[0] for n in names if '/' in n}
    strip = len(names) > 0 and all('/' in n for n in names) and len(roots) == 1
    dest_root = os.path.realpath(dest)
    flattened_from = {}  # expected basename -> (archive entry, CRC)
    for name in names:
      rel = name.split('/', 1)[1] if strip else name
      base = rel.replace('\\', '/').rsplit('/', 1)[-1]
      if base in known:
        # Place expected CSVs flat, wherever they were nested — but never
        # let two archive entries with the SAME basename and DIFFERENT
        # content silently overwrite each other (entry order would decide
        # which copy a long fit trains on).
        crc = zf.getinfo(name).CRC
        prior = flattened_from.get(base)
        if prior is not None:
          if prior[1] != crc:
            raise SystemExit(
                f'archive carries two different copies of {base!r} '
                f'({prior[0]!r} and {name!r}); cannot decide which is the '
                'dataset — re-run with --no-flatten and place the '
                'right one at the data root yourself.'
            )
          continue  # identical duplicate: keep the first
        flattened_from[base] = (name, crc)
        rel = base
      # Zip-slip guard: reject absolute entries and any '..' path
      # component (a mid-path '..' escapes dest just as a leading one
      # does), then double-check the resolved path stays under dest.
      parts = rel.replace('\\', '/').split('/')
      if not rel or rel.startswith('/') or '..' in parts:
        continue
      out = os.path.join(dest, rel)
      if os.path.commonpath(
          [dest_root, os.path.realpath(out)]
      ) != dest_root:
        continue
      os.makedirs(os.path.dirname(out) or dest, exist_ok=True)
      with zf.open(name) as src, open(out, 'wb') as dst:
        dst.write(src.read())


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--dest', default='datasets',
                      help='directory to place the CSVs in')
  parser.add_argument('--archive', default=None,
                      help='pre-downloaded datasets.zip (skips the download)')
  parser.add_argument('--verify-only', action='store_true',
                      help='only check an existing --dest layout')
  parser.add_argument('--list', action='store_true', dest='list_mode',
                      help='print found-vs-expected per dataset and exit '
                           '(no download, no unpack)')
  parser.add_argument('--deep', action='store_true',
                      help='also verify each CSV is non-empty and its '
                           'header carries the registry columns')
  parser.add_argument('--datasets', nargs='*', default=None,
                      help='subset to verify (default: all six)')
  parser.add_argument('--no-flatten', action='store_true',
                      help='unpack the archive tree as-is (no basename '
                           'flattening) — the recovery path when the '
                           'archive carries two different copies of an '
                           'expected CSV; place the right one at the '
                           'data root yourself afterwards')
  args = parser.parse_args(argv)

  if args.list_mode:
    any_missing = False
    for dataset in args.datasets or registry.runnable_datasets():
      names = expected_files(dataset)
      found = [n for n in names if os.path.exists(
          os.path.join(args.dest, n))]
      absent = [n for n in names if n not in set(found)]
      any_missing |= bool(absent)
      print(f'{dataset}: {len(found)}/{len(names)} expected files present')
      for n in absent[:4]:
        print(f'  missing: {n}')
      if len(absent) > 4:
        print(f'  ... and {len(absent) - 4} more')
    return 1 if any_missing else 0

  if not args.verify_only:
    archive = args.archive
    if archive is None:
      archive = os.path.join(args.dest, 'datasets.zip')
      os.makedirs(args.dest, exist_ok=True)
      download(archive)
    unpack(archive, args.dest, flatten_known=not args.no_flatten)

  problems = verify_layout(args.dest, args.datasets, deep=args.deep)
  if problems:
    for dataset, bad in problems.items():
      print(f'{dataset}: {len(bad)} problem(s) (first: {bad[0]})')
    return 1
  checked = args.datasets or registry.runnable_datasets()
  print(f'ok: {", ".join(checked)} complete under {args.dest}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
