"""ETL / chaining / generator tests (reference data_utils.py + data_prep)."""

import numpy as np
import pytest

from bert4clickpath.constants import CLS_ID, PAD_ID, SEP_ID
from bert4clickpath.data import chaining, etl
from bert4clickpath.data.generator import ClickStreamGenerator


def test_chained_length_and_bounds():
    # [CLS][SEP] s1(3) [SEP] s2(2) [SEP] -> 2 + 4 + 3 = 9 tokens
    lens = [3, 2]
    assert chaining.chained_length(lens) == 9
    assert chaining.segment_bounds(lens, 0) == (0, 1)  # CLS
    assert chaining.segment_bounds(lens, 1) == (2, 5)
    assert chaining.segment_bounds(lens, 2) == (6, 8)
    with pytest.raises(ValueError):
        chaining.segment_bounds(lens, 3)


def test_chain_sequences_layout():
    s1 = np.array([[11, 12, PAD_ID]], np.int32)
    s2 = np.array([[21, 22]], np.int32)
    chained = chaining.chain_sequences([s1, s2])
    np.testing.assert_array_equal(
        chained[0], [CLS_ID, SEP_ID, 11, 12, PAD_ID, SEP_ID, 21, 22, SEP_ID]
    )


def test_group_sequences():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame(
        {
            "user": ["u1", "u1", "u2", "u1", "u2"],
            "item": ["a", "b", "c", "d", "e"],
            "event": ["v", "v", "w", "x", "w"],
        }
    )
    gids, feats = etl.group_sequences(df, "user")
    assert gids == ["u1", "u2"]
    assert list(feats["item"][0]) == ["a", "b", "d"]  # order preserved
    assert list(feats["event"][1]) == ["w", "w"]
    # truncation (data_prep/main.py:69-70 semantics: first N rows per group)
    _, feats2 = etl.group_sequences(df, "user", max_seq_len=2)
    assert list(feats2["item"][0]) == ["a", "b"]


def test_train_test_split_by_group():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"user": [f"u{i}" for i in range(50) for _ in range(3)], "x": 0})
    train, test = etl.train_test_split(df, "user", 0.8, seed=0)
    train_users = set(train["user"])
    test_users = set(test["user"])
    assert not train_users & test_users
    assert len(train_users) + len(test_users) == 50


def test_packed_roundtrip(tmp_path):
    seqs = [np.arange(i + 1, dtype=np.int32) for i in range(25)]
    files = etl.write_packed(seqs, str(tmp_path), "t", records_per_shard=10)
    assert len(files) == 3
    back = etl.read_packed(str(tmp_path / "t_*.npz"))
    assert len(back) == 25
    for a, b in zip(seqs, back):
        np.testing.assert_array_equal(a, b)


def test_generator_deterministic(tmp_path):
    g1 = ClickStreamGenerator(n_items=40, seed=3)
    g2 = ClickStreamGenerator(n_items=40, seed=3)
    i1, e1 = g1.generate_sessions(5)
    i2, _ = g2.generate_sessions(5)
    for a, b in zip(i1, i2):
        np.testing.assert_array_equal(a, b)
    assert all(0 <= s.max() < 40 for s in i1)
    assert all(len(s) >= 5 for s in i1)
    assert len(e1) == 5


def test_generator_interface_and_vocab_files(tmp_path):
    # Signature parity with the reference's intended module
    # (source/main.py:223-224).
    gen = ClickStreamGenerator(
        n_items=12,
        n_events=4,
        session_cohesiveness=100,
        write_vocab_files=True,
        vocab_dir=str(tmp_path),
        seed=0,
    )
    assert (tmp_path / "item_vocab.txt").exists()
    assert gen.item_vocab().size == 12
    it = gen()
    ex = next(it)
    assert set(ex) == {"asin", "reviewerID"}
    assert len(ex["asin"]) >= 5


def test_beauty_loader_format(tmp_path):
    # synthetic beauty.txt: "user item" pairs
    lines = []
    for u in range(3):
        for i in range(6):
            lines.append(f"u{u} item{(u * 2 + i) % 8}")
    p = tmp_path / "beauty.txt"
    p.write_text("\n".join(lines) + "\n")
    from bert4clickpath.data.beauty import load_beauty

    seqs, vocab = load_beauty(str(p), max_seq_len=4)
    assert len(seqs) == 3
    assert all(len(s) == 4 for s in seqs)  # first-4 truncation
    # first-appearance vocab: u0's items come first
    assert vocab.tokens[0] == "item0"


def test_packed_dataset_multifeature_roundtrip(tmp_path):
    items = [np.arange(i + 2, dtype=np.int32) for i in range(12)]
    events = [np.arange(i + 2, dtype=np.int32) * 2 for i in range(12)]
    files = etl.write_packed_dataset(
        {"items": items, "events": events}, str(tmp_path), records_per_shard=5
    )
    assert len(files) == 3
    back, ctx = etl.read_packed_dataset(str(tmp_path / "dataset_*.npz"))
    assert set(back) == {"items", "events"} and ctx == {}
    for a, b in zip(items, back["items"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(events, back["events"]):
        np.testing.assert_array_equal(a, b)


def test_packed_dataset_context_and_2d_roundtrip(tmp_path):
    """SequenceExample-surface parity (reference data_utils.py:127-396):
    per-group scalar context features and 2-D list features round-trip."""
    rng = np.random.default_rng(0)
    n = 12
    items = [rng.integers(0, 50, size=rng.integers(1, 9)).astype(np.int32) for _ in range(n)]
    # 2-D list feature: one fixed-width float row per event
    embeds = [rng.normal(size=(len(s), 4)).astype(np.float32) for s in items]
    country = np.array([f"c{i % 3}" for i in range(n)])
    age = np.arange(n, dtype=np.int32) + 20
    files = etl.write_packed_dataset(
        {"items": items, "embeds": embeds},
        str(tmp_path),
        records_per_shard=5,
        context={"country": country, "age": age},
    )
    assert len(files) == 3
    back, ctx = etl.read_packed_dataset(str(tmp_path / "dataset_*.npz"))
    for a, b in zip(items, back["items"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(embeds, back["embeds"]):
        assert b.shape == a.shape  # 2-D restored, not flattened
        np.testing.assert_allclose(a, b)
    np.testing.assert_array_equal(ctx["country"], country)
    np.testing.assert_array_equal(ctx["age"], age)


def test_packed_dataset_mmap_roundtrip(tmp_path):
    """mmap layout: .npy-directory shards load as zero-copy views."""
    rng = np.random.default_rng(1)
    items = [rng.integers(0, 50, size=rng.integers(1, 9)).astype(np.int32) for _ in range(7)]
    files = etl.write_packed_dataset(
        {"items": items},
        str(tmp_path),
        records_per_shard=4,
        context={"uid": np.arange(7)},
        mmap=True,
    )
    assert all(not f.endswith(".npz") for f in files)
    back, ctx = etl.read_packed_dataset(str(tmp_path / "dataset_*"), mmap=True)
    for a, b in zip(items, back["items"]):
        np.testing.assert_array_equal(a, b)
    # genuinely memory-mapped: the view's base chain reaches a np.memmap
    buf = back["items"][0]
    base = buf.base
    while base is not None and not isinstance(base, np.memmap):
        base = base.base
    assert isinstance(base, np.memmap)
    np.testing.assert_array_equal(ctx["uid"], np.arange(7))


def test_packed_dataset_2d_width_mismatch_raises(tmp_path):
    bad = [np.zeros((2, 3)), np.zeros((1, 4))]
    with pytest.raises(ValueError):
        etl.write_packed_dataset({"x": bad}, str(tmp_path))


def test_amazon_json_loader(tmp_path):
    """Reference read_raw_amazon_data semantics (data_prep/main.py:9-42):
    gzip JSON-lines, min_item_per_user on pre-truncation counts, global
    unixReviewTime sort (stable on ties), then the shared truncate+vocab tail.
    """
    import gzip
    import json

    import numpy as np

    from bert4clickpath.data.beauty import load_amazon_json

    recs = [
        # u1: 3 reviews, out of time order in the file
        {"reviewerID": "u1", "asin": "b", "unixReviewTime": 200, "extra": 1},
        {"reviewerID": "u1", "asin": "a", "unixReviewTime": 100},
        {"reviewerID": "u1", "asin": "c", "unixReviewTime": 300},
        # u2: only 1 review -> dropped by min_item_per_user=2
        {"reviewerID": "u2", "asin": "z", "unixReviewTime": 50},
        # u3: 2 reviews sharing a timestamp -> stable sort keeps file order
        {"reviewerID": "u3", "asin": "d", "unixReviewTime": 150},
        {"reviewerID": "u3", "asin": "e", "unixReviewTime": 150},
    ]
    p = tmp_path / "reviews.json.gz"
    with gzip.open(p, "wt") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")

    seqs, vocab = load_amazon_json(str(p), min_item_per_user=2, max_seq_len=50)
    decoded = {
        tuple(vocab.decode_label(i) for i in s) for s in map(np.asarray, seqs)
    }
    # u2 filtered out; u1 time-ordered a,b,c; u3 tie keeps file order d,e
    assert decoded == {("a", "b", "c"), ("d", "e")}
    # first-appearance vocab over the time-sorted stream: a(100) d(150) e(150)
    # b(200) c(300)
    assert vocab.tokens == ["a", "d", "e", "b", "c"]

    # first-N truncation happens after the time sort
    seqs2, _ = load_amazon_json(str(p), min_item_per_user=2, max_seq_len=2)
    lens = sorted(len(s) for s in seqs2)
    assert lens == [2, 2]


def test_prepare_data_amazon_json_cli(tmp_path):
    import gzip
    import json
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from examples.bert4rec.prepare_data import main as prep_main

    p = tmp_path / "reviews.json.gz"
    with gzip.open(p, "wt") as f:
        for i in range(12):
            f.write(
                json.dumps(
                    {
                        "reviewerID": f"u{i % 3}",
                        "asin": f"item{i % 5}",
                        "unixReviewTime": 1000 + i,
                    }
                )
                + "\n"
            )
    out = tmp_path / "prepared"
    prep_main(
        [
            "--input", str(p), "--format", "amazon_json",
            "--min_item_per_user", "2", "--output", str(out),
            "--records_per_shard", "2",
        ]
    )
    assert (out / "vocabs" / "item_vocab.txt").exists()
    from bert4clickpath.data import etl

    seqs = list(etl.read_packed(str(out / "sequences_*.npz")))
    assert len(seqs) == 3  # u0,u1,u2 all have >=2 reviews


def test_amazon_json_skips_malformed_records(tmp_path):
    """A record missing reviewerID/asin/unixReviewTime is skipped with a
    warning (the reference's pandas use_columns carried NaN rows instead of
    aborting, data_prep/main.py:9-42) — one bad line must not kill the run."""
    import gzip
    import json

    import numpy as np
    import pytest

    from bert4clickpath.data.beauty import load_amazon_json

    recs = [
        {"reviewerID": "u1", "asin": "a", "unixReviewTime": 100},
        {"asin": "ghost", "unixReviewTime": 1},  # no reviewerID
        {"reviewerID": "u1", "unixReviewTime": 2},  # no asin
        {"reviewerID": "u1", "asin": "b", "unixReviewTime": 200},
    ]
    p = tmp_path / "reviews.json.gz"
    with gzip.open(p, "wt") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")

    with pytest.warns(UserWarning, match="skipped 2 record"):
        seqs, vocab = load_amazon_json(str(p), min_item_per_user=2, max_seq_len=50)
    assert vocab.tokens == ["a", "b"]
    assert [list(map(vocab.decode_label, np.asarray(s))) for s in seqs] == [["a", "b"]]


def test_amazon_json_tolerates_malformed_timestamps(tmp_path):
    """Null / non-numeric unixReviewTime skips the record (same as a
    missing key) instead of killing the ingestion (code-review round 4)."""
    import gzip
    import json as _json
    import warnings

    from bert4clickpath.data.beauty import load_amazon_json

    recs = [
        {"reviewerID": "u1", "asin": f"a{i}", "unixReviewTime": 100 + i}
        for i in range(5)
    ]
    recs.insert(2, {"reviewerID": "u1", "asin": "bad", "unixReviewTime": None})
    recs.insert(4, {"reviewerID": "u1", "asin": "bad2", "unixReviewTime": "n/a"})
    p = tmp_path / "r.json.gz"
    with gzip.open(p, "wt") as f:
        for r in recs:
            f.write(_json.dumps(r) + "\n")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        seqs, vocab = load_amazon_json(str(p), max_seq_len=50, min_item_per_user=1)
    assert any("malformed" in str(x.message) for x in w)
    assert [[vocab.tokens[i] for i in s] for s in seqs] == [
        [f"a{i}" for i in range(5)]
    ]
