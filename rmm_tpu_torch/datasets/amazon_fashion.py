"""Amazon Fashion reviews (``rmm_tpu/datasets/amazon_fashion.py``): the
text + tabular family. A review is an edge reviewer → item over one node
id space; ``verified``, ``reviewerID`` and ``asin`` categorical,
``unixReviewTime`` a timestamp, ``vote`` numerical, ``reviewText`` and
``summary`` text, the ``overall`` rating the regression target
(``n_classes = 1``), split ``temporal`` on ``unixReviewTime``.

A text column is materialized as ``text_embedded`` (the hashing
embedder's vectors, 128 wide) or ``text_tokenized`` (the hashing
tokenizer's 64 ids, read by a text model in the forward).

The CSV is read without pandas but as its reader reads it
(``base.read_csv_columns``: every field through the ``csv`` module, so
quoted fields may hold commas, quotes and newlines; a cell that pandas
reads as missing, such as ``NA`` or ``null``, is empty), a missing text
as the empty one, the node ids from the sorted union of
``str(reviewerID)`` and ``"a_" + str(asin)`` (pandas' category codes).
"""
from __future__ import annotations

import json

import numpy as np

from ..frame.stype import Stype
from ..nn.text import HashingTokenizer, get_text_embedder
from .base import (read_csv_columns, shared_node_ids, text_cells,
                   write_csv_columns)
from .graph_dataset import EdgeTable, GraphTableDataset, NodeTable

TEXT_COLS = ("reviewText", "summary")


class AmazonFashionDataset(GraphTableDataset):
    def __init__(self, root: str, text_stype: Stype = Stype.text_embedded):
        """The reviews at ``root``, their text columns ``text_stype``: the
        hashing embedder's 128-wide vectors or the hashing tokenizer's 64
        ids. The reference's pretraining targets and pretrained text
        models are on no path of the port (``--text_model`` takes
        ``hashing`` alone)."""
        if text_stype == Stype.text_embedded:
            encode = get_text_embedder("hashing", dim=128)
        elif text_stype == Stype.text_tokenized:
            encode = HashingTokenizer()
        else:
            raise ValueError(f"text_stype must be text_embedded or "
                             f"text_tokenized, got {text_stype}")
        columns = read_csv_columns(root)
        columns["reviewer_node"], columns["asin_node"] = shared_node_ids(
            columns["reviewerID"], columns["asin"])
        schema = {"verified": Stype.categorical,
                  "reviewerID": Stype.categorical,
                  "asin": Stype.categorical,
                  "unixReviewTime": Stype.timestamp,
                  "vote": Stype.numerical}
        for c in TEXT_COLS:
            if c in columns:
                columns[c] = encode(text_cells(columns[c]))
                schema[c] = text_stype
        edges = EdgeTable(
            columns, schema, src_col="reviewer_node", dst_col="asin_node",
            timestamp_col="unixReviewTime", supervised_col="overall",
            split_type="temporal", cache_root=root)
        nodes = NodeTable.synthetic(edges.graph.num_nodes - 1)
        super().__init__(edges, nodes)
        self.n_classes = 1   # regression on the rating


def retrieve_dataset(json_path: str, csv_path: str) -> str:
    """JSON-lines reviews (the published file) → the CSV this dataset
    reads, in pandas' ``to_csv`` format; the download itself is not
    done here."""
    keys = ("overall", "verified", "reviewerID", "asin", "reviewText",
            "summary", "unixReviewTime", "vote")
    rows = []
    with open(json_path) as f:
        for line in f:
            r = json.loads(line)
            rows.append((r.get("overall", 0.0), r.get("verified", False),
                         r.get("reviewerID", ""), r.get("asin", ""),
                         r.get("reviewText", ""), r.get("summary", ""),
                         r.get("unixReviewTime", 0),
                         float(str(r.get("vote", "0")).replace(",", ""))))
    columns = {k: np.array([row[i] for row in rows],
                           dtype=object if k in ("reviewerID", "asin",
                                                 *TEXT_COLS) else None)
               for i, k in enumerate(keys)}
    write_csv_columns(csv_path, columns)
    return csv_path


def synthetic_amazon_fashion(path: str, num_rows: int = 600,
                             num_reviewers: int = 60, num_items: int = 30,
                             seed: int = 0) -> str:
    """Reviews with a learnable text → rating signal, byte for byte the
    JAX package's ``synthetic_amazon_fashion`` file: ratings 1-5, four
    words of a positive (4-5), negative (1-2) or neutral lexicon and four
    neutral ones in a shuffled review, its first three the summary."""
    rng = np.random.RandomState(seed)
    pos_words = ["great", "love", "perfect", "comfortable", "beautiful"]
    neg_words = ["terrible", "broke", "cheap", "awful", "returned"]
    neutral = ["shirt", "dress", "shoes", "fabric", "color", "size", "fit"]
    keys = ("overall", "verified", "reviewerID", "asin", "reviewText",
            "summary", "unixReviewTime", "vote")
    rows = []
    for _ in range(num_rows):
        rating = rng.randint(1, 6)
        lexicon = pos_words if rating >= 4 else (
            neg_words if rating <= 2 else neutral)
        words = list(rng.choice(lexicon, 4)) + list(rng.choice(neutral, 4))
        rng.shuffle(words)
        rows.append((float(rating), bool(rng.rand() < 0.8),
                     f"R{rng.randint(num_reviewers)}",
                     f"B{rng.randint(num_items):05d}", " ".join(words),
                     " ".join(words[:3]),
                     int(rng.randint(1500000000, 1600000000)),
                     float(rng.randint(0, 50))))
    columns = {k: np.array([row[i] for row in rows],
                           dtype=object if i in (2, 3, 4, 5) else None)
               for i, k in enumerate(keys)}
    write_csv_columns(path, columns)
    return path
