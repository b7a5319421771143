"""Offline data prep: beauty.txt (or any "user item" text log) -> packed
ragged shards + item vocabulary.

Counterpart of the reference's examples/BERT4Rec/data_prep/main.py: per-user
truncation to the first N interactions, first-appearance vocabulary, sharded
output — but to npz packed arrays instead of TFRecords (data/etl.py).

  python examples/bert4rec/prepare_data.py \
      --input /root/reference/examples/BERT4Rec/raw_data/beauty.txt \
      --output /tmp/beauty_prepared

Raw Amazon dumps (json.gz from https://jmcauley.ucsd.edu/data/amazon/,
reference read_raw_amazon_data at data_prep/main.py:9-42):

  python examples/bert4rec/prepare_data.py \
      --input reviews_Beauty.json.gz --format amazon_json \
      --min_item_per_user 5 --output /tmp/beauty_prepared
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from bert4clickpath.data import etl
from bert4clickpath.data.beauty import load_amazon_json, load_beauty


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="'user item' pairs, one per line")
    p.add_argument("--output", required=True)
    p.add_argument(
        "--format",
        default="pairs_txt",
        choices=["pairs_txt", "amazon_json"],
        help="pairs_txt: 'user item' lines (FeiSun/BERT4Rec beauty.txt); "
        "amazon_json: raw Amazon reviews json(.gz), reference "
        "data_prep/main.py:9-42",
    )
    p.add_argument("--max_seq_len", type=int, default=50)
    p.add_argument("--min_feedback", type=int, default=0)
    p.add_argument(
        "--min_item_per_user",
        type=int,
        default=5,
        help="amazon_json only: drop users with fewer total reviews "
        "(pre-truncation, reference main.py:36-38)",
    )
    p.add_argument("--records_per_shard", type=int, default=10_000)
    args = p.parse_args(argv)

    if args.format == "amazon_json":
        sequences, vocab = load_amazon_json(
            args.input,
            min_item_per_user=args.min_item_per_user,
            max_seq_len=args.max_seq_len,
        )
    else:
        sequences, vocab = load_beauty(
            args.input, max_seq_len=args.max_seq_len, min_feedback=args.min_feedback
        )
    print(f"# of sequences: {len(sequences)}")
    print(f"# of items: {vocab.size}")
    print(f"# of interactions: {sum(len(s) for s in sequences)}")

    os.makedirs(args.output, exist_ok=True)
    vocab.save(os.path.join(args.output, "vocabs", "item_vocab.txt"))
    files = etl.write_packed(
        sequences, args.output, "sequences", records_per_shard=args.records_per_shard
    )
    print(f"wrote {len(files)} shard(s) to {args.output}")


if __name__ == "__main__":
    main()
