"""Merge per-object BOP19 result CSVs into one submission file (counterpart
of checkerpose_tpu/cli/merge_csv.py, same flags):

  python -m checkerpose_tpu_torch.cli.merge_csv --input_dir out/ --output_fn all.csv

Every *.csv of --input_dir, sorted by name and concatenated under one header
(`eval/csv_writer.py::merge_csv`), the output itself left out; a relative
--output_fn lands in --input_dir.
"""
from __future__ import annotations

import argparse
import glob
import os

from checkerpose_tpu_torch.eval.csv_writer import merge_csv


def main(argv=None):
    ap = argparse.ArgumentParser(description="merge per-object BOP19 CSVs")
    ap.add_argument("--input_dir", type=str, required=True)
    ap.add_argument("--output_fn", type=str, required=True)
    args = ap.parse_args(argv)

    out = args.output_fn
    if not os.path.isabs(out):
        out = os.path.join(args.input_dir, out)
    paths = sorted(p for p in glob.glob(os.path.join(args.input_dir, "*.csv"))
                   if os.path.abspath(p) != os.path.abspath(out))
    print([os.path.basename(p) for p in paths])
    merge_csv(paths, out)
    print("merged ->", out)
    return out


if __name__ == "__main__":
    main()
