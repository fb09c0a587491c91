"""The text modules of the PyTorch port against the JAX package on the CPU:
the hashing embedder and tokenizer (bit for bit), the pooling functions,
``LoRADense`` (with and without ``freeze_base``), the text LM
``TextToEmbeddingFinetune``, the text encoders (``LinearModelEncoder``
with its shared LM, ``LinearEmbeddingEncoder``) in the stype dispatcher,
``SupervisedHead``, forward and gradients (``jax.vjp`` against autograd);
``AmazonFashionDataset``'s tensor frame for both text stypes on a CSV
whose text fields hold a quoted comma, a quote, a newline and missing
cells; the synthetic and JSON-lines writers byte for byte; and the
attention cores' shared-memory budget as a pure function at an H100's
numbers.

Every JAX leaf is randomized and carried over with ``from_jax``.
Tolerance 1e-5 absolute and relative (float32, sums in another order);
the hashing functions and the tensor frames are compared for equality.
"""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.datasets import amazon_fashion as jaf
from rmm_tpu.frame.stype import Stype as JStype
from rmm_tpu.frame.tensor_frame import TensorFrame as JTensorFrame
from rmm_tpu.nn import decoders as jdec
from rmm_tpu.nn import encoders as jenc
from rmm_tpu.nn import text as jtext
from rmm_tpu.utils import pooling as jpool
from rmm_tpu_torch.convert import from_jax
from rmm_tpu_torch.datasets import amazon_fashion as af
from rmm_tpu_torch.datasets.base import (read_csv_columns, text_cells,
                                        write_csv_columns)
from rmm_tpu_torch.frame.stats import StatType
from rmm_tpu_torch.frame.stype import Stype
from rmm_tpu_torch.frame.tensor_frame import TensorFrame
from rmm_tpu_torch.nn import decoders, encoders, text
from rmm_tpu_torch.ops import column_attention as ca
from rmm_tpu_torch.utils import pooling
from tests.torch_port_util import init_random, load_from_jax, \
    one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
#: an H100's shared memory: a block may opt into 232,448 bytes, an SM
#: holds 233,472 (cudaDevAttrMaxSharedMemoryPerBlockOptin and
#: cudaDevAttrMaxSharedMemoryPerMultiprocessor)
H100_BLOCK, H100_SM = 232_448, 233_472
WORDS = ["Great", "fit", "love", "it,", "broke", "after", "a", "week",
         "ÜBER", "soft", "colour", "ok", "returned", "size", "été"]


def sentences(seed: int, n: int) -> list:
    rng = np.random.RandomState(seed)
    out = [" ".join(rng.choice(WORDS, rng.randint(0, 90)))
           for _ in range(n)]
    return out + ["", None, "a", "ab", "  spaced   out  "]


def close(port_out, jax_out):
    np.testing.assert_allclose(port_out.detach().numpy(),
                               np.asarray(jax_out), **TOL)


def check_grads(module, variables, jax_fn, port_out, jax_out,
                port_inputs=(), jax_grads_of_inputs=()):
    """Autograd of ``(port_out · g).sum()`` against ``jax.vjp`` of
    ``jax_fn(params)`` at the same cotangent ``g``, for every parameter
    (in the port's layout) and the given inputs."""
    g = np.random.RandomState(3).randn(*np.shape(jax_out)).astype(
        np.float32)
    (port_out * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(jax_fn, variables["params"], *jax_grads_of_inputs)
    grads = vjp(jnp.asarray(g))
    want = from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                      grads[0])}, module)
    for name, p in module.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
    for x, gx in zip(port_inputs, grads[1:]):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **TOL)


# -- hashing ----------------------------------------------------------------

@pytest.mark.parametrize("dim,seed", [(128, 0), (256, 0), (64, 5)])
def test_hashing_embedder_is_bit_identical(dim, seed):
    texts = sentences(dim + seed, 40)
    want = jtext.HashingTextEmbedder(dim=dim, seed=seed)(texts)
    got = text.HashingTextEmbedder(dim=dim, seed=seed)(texts)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got_again = text.get_text_embedder("hashing", dim=dim, seed=seed)(texts)
    np.testing.assert_array_equal(got_again, want)


@pytest.mark.parametrize("vocab,max_length", [(8192, 64), (50, 7)])
def test_hashing_tokenizer_is_bit_identical(vocab, max_length):
    texts = sentences(vocab, 40)
    want = jtext.HashingTokenizer(vocab, max_length)(texts)
    got = text.HashingTokenizer(vocab, max_length)(texts)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_other_text_models_are_refused_by_name():
    with pytest.raises(ValueError, match="'intfloat/e5-mistral-7b"):
        text.get_text_embedder("intfloat/e5-mistral-7b-instruct")


# -- pooling, LoRA, the LM --------------------------------------------------

def test_pooling_matches_jax_with_gradients():
    rng = np.random.RandomState(0)
    h = rng.randn(6, 9, 5).astype(np.float32)
    mask = (rng.rand(6, 9) < 0.6).astype(np.float32)
    mask[0] = 0.0                       # no attended token
    for jfn, fn in ((jpool.mean_pooling, pooling.mean_pooling),
                    (jpool.last_pooling, pooling.last_pooling)):
        x = torch.from_numpy(h).requires_grad_()
        out = fn(x, torch.from_numpy(mask))
        want, vjp = jax.vjp(lambda a: jfn(a, jnp.asarray(mask)),
                            jnp.asarray(h))
        close(out, want)
        g = rng.randn(*out.shape).astype(np.float32)
        (out * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(),
                                   np.asarray(vjp(jnp.asarray(g))[0]), **TOL)


@pytest.mark.parametrize("rank,freeze", [(8, False), (8, True), (0, False)])
def test_lora_dense_matches_jax(rank, freeze):
    x = np.random.RandomState(rank).randn(5, 7, 12).astype(np.float32)
    jm = jtext.LoRADense(10, rank=rank, freeze_base=freeze)
    variables = init_random(jm, jnp.asarray(x), seed=rank)
    m = load_from_jax(text.LoRADense(12, 10, rank=rank, freeze_base=freeze),
                      variables)
    xt = torch.from_numpy(x).requires_grad_()
    out = m(xt)
    want = jm.apply(variables, jnp.asarray(x))
    close(out, want)
    check_grads(m, variables, lambda p, a: jm.apply({"params": p}, a), out,
                want, [xt], [jnp.asarray(x)])
    if freeze:   # the base gets no gradient, the adapters do
        assert m.weight.grad is None and m.bias.grad is None
        assert m.lora_a.grad.abs().sum() > 0


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_text_lm_matches_jax(lora_rank):
    """The LM at hidden 16, 4 heads, 2 layers on rows with padding (whose
    positions it attends to) and ids past the vocabulary (clipped)."""
    rng = np.random.RandomState(lora_rank)
    ids = rng.randint(1, 40, (6, 12)).astype(np.int32)
    ids[0, 5:] = 0
    ids[1, :] = 0
    ids[2, 3] = 77
    kw = dict(hidden=16, num_layers=2, nhead=4, vocab_size=50,
              max_length=16, lora_rank=lora_rank)
    jm = jtext.TextToEmbeddingFinetune(**kw)
    variables = init_random(jm, jnp.asarray(ids), seed=lora_rank)
    m = load_from_jax(text.TextToEmbeddingFinetune(**kw), variables)
    out = m(torch.from_numpy(ids))
    want = jm.apply(variables, jnp.asarray(ids))
    assert out.shape == (6, 16)
    close(out, want)
    check_grads(m, variables,
                lambda p: jm.apply({"params": p}, jnp.asarray(ids)), out,
                want)


# -- encoders and head ------------------------------------------------------

def lm_kw():
    return dict(hidden=16, num_layers=1, nhead=4, vocab_size=60,
                max_length=10, lora_rank=4)


@pytest.mark.parametrize("mixed", [False, True], ids=["tokens", "mixed"])
def test_text_encoders_match_jax(mixed):
    """``text_tokenized`` columns through one shared LM and a linear map a
    column (the LM's parameters once, as ``text_model``), and with
    ``mixed`` the ``text_embedded``, numerical, categorical and timestamp
    blocks beside them, in stype order."""
    rng = np.random.RandomState(int(mixed))
    n, c = 9, 8
    blocks = {"text_tokenized": rng.randint(0, 70, (n, 2, 10)).astype(
        np.int32)}
    names = {"text_tokenized": ("review", "summary")}
    config = {"text_tokenized": {"model_dim": 16}}
    if mixed:
        blocks.update(numerical=rng.randn(n, 1).astype(np.float32),
                      categorical=rng.randint(-1, 3, (n, 2)).astype(
                          np.int32),
                      timestamp=rng.randint(0, 10 ** 9, (n, 1)),
                      text_embedded=rng.randn(n, 3, 12).astype(np.float32))
        names.update(numerical=("vote",), categorical=("a", "b"),
                     timestamp=("t",), text_embedded=("e0", "e1", "e2"))
        config.update(numerical={"means": (0.1,), "stds": (1.3,)},
                      categorical={"cardinalities": (3, 3)},
                      text_embedded={"emb_dim": 12})
    jenc_ = jenc.StypeWiseFeatureEncoder(
        channels=c, col_names={JStype[k]: v for k, v in names.items()},
        col_config={JStype[k]: v for k, v in config.items()},
        text_model=jtext.TextToEmbeddingFinetune(**lm_kw()))
    jtf = JTensorFrame(feats={JStype[k]: jnp.asarray(v)
                              for k, v in blocks.items()},
                       col_names={JStype[k]: list(v)
                                  for k, v in names.items()})
    variables = init_random(jenc_, jtf)
    assert set(variables["params"]["text_tokenized"]) == {"weight", "bias"}
    enc = load_from_jax(encoders.StypeWiseFeatureEncoder(
        c, {Stype[k]: v for k, v in names.items()},
        {Stype[k]: v for k, v in config.items()},
        text.TextToEmbeddingFinetune(**lm_kw())), variables)
    tf = TensorFrame(feats={Stype[k]: torch.from_numpy(np.asarray(v))
                            for k, v in blocks.items()},
                     col_names={Stype[k]: list(v) for k, v in names.items()})
    out = enc(tf)
    want, _ = jenc_.apply(variables, jtf)
    assert out.shape == (n, sum(len(v) for v in names.values()), c)
    close(out, want)
    check_grads(enc, variables,
                lambda p: jenc_.apply({"params": p}, jtf)[0], out, want)


def test_text_columns_need_a_text_model():
    with pytest.raises(ValueError, match="need a text model"):
        encoders.StypeWiseFeatureEncoder(
            8, {Stype.text_tokenized: ("r",)},
            {Stype.text_tokenized: {"model_dim": 8}})


def test_supervised_head_matches_jax():
    x = np.random.RandomState(2).randn(7, 16).astype(np.float32)
    jm = jdec.SupervisedHead(16, 1)
    variables = init_random(jm, jnp.asarray(x))
    m = load_from_jax(decoders.SupervisedHead(16, 1), variables)
    xt = torch.from_numpy(x).requires_grad_()
    out = m(xt)
    want = jm.apply(variables, jnp.asarray(x))
    close(out, want)
    check_grads(m, variables, lambda p, a: jm.apply({"params": p}, a), out,
                want, [xt], [jnp.asarray(x)])


# -- the dataset ------------------------------------------------------------

TRICKY = {3: ("Fits well, runs small", "ok, fine"),
          5: ('He said "great" twice', '"quoted"'),
          8: ("", "no review"),
          11: ("first line\nsecond line", "two\r\nlines"),
          14: ("NA", ""),
          17: ("null", "n/a")}


@pytest.fixture(scope="module")
def tricky_csv(tmp_path_factory):
    """The synthetic reviews with text fields pandas has to unquote: a
    comma, a quote, an empty review, newlines, and cells pandas reads as
    missing ("NA", "null", "n/a")."""
    d = tmp_path_factory.mktemp("amazon")
    path = jaf.synthetic_amazon_fashion(str(d / "base.csv"), num_rows=160,
                                        num_reviewers=20, num_items=12)
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    i, j = header.index("reviewText"), header.index("summary")
    for r, (review, summary) in TRICKY.items():
        body[r][i], body[r][j] = review, summary
    out = str(d / "tricky.csv")
    with open(out, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows([header] + body)
    return out


@pytest.mark.parametrize("stype", ["text_embedded", "text_tokenized"])
def test_amazon_fashion_frame_equals_jax(tricky_csv, stype):
    jds = jaf.AmazonFashionDataset(tricky_csv, text_stype=JStype[stype])
    ds = af.AmazonFashionDataset(tricky_csv, text_stype=Stype[stype])
    jtf, tf = jds.edges.tensor_frame, ds.edges.tensor_frame
    assert {int(k): v for k, v in jtf.col_names.items()} == {
        int(k): v for k, v in tf.col_names.items()}
    assert set(map(int, jtf.feats)) == set(map(int, tf.feats))
    for st, block in tf.feats.items():
        want = np.asarray(jtf.feats[JStype(int(st))])
        assert block.dtype == want.dtype, st
        np.testing.assert_array_equal(block, want, err_msg=str(st))
    np.testing.assert_array_equal(tf.y, np.asarray(jtf.y))
    for jv, v in zip(jds.edges.split(), ds.edges.split()):
        np.testing.assert_array_equal(v.indices, jv.indices)
    assert ds.graph.num_nodes == jds.graph.num_nodes
    assert ds.n_classes == jds.n_classes == 1
    for col in ("verified", "reviewerID", "asin"):
        want = jds.edges.col_stats[col]
        got = ds.edges.col_stats[col][StatType.COUNT]
        assert [str(v) for v in got[0]] == [str(v) for v in
                                            next(iter(want.values()))[0]]


def test_read_texts_reads_fields_as_pandas_does(tricky_csv):
    import pandas as pd

    df = pd.read_csv(tricky_csv)
    columns = read_csv_columns(tricky_csv)
    for col in af.TEXT_COLS:
        assert text_cells(columns[col]) == df[col].fillna("").tolist()
    got = text_cells(columns["reviewText"])
    assert got[11] == "first line\nsecond line" and got[14] == ""


@pytest.mark.parametrize("cells,want", [
    (["NA", "x", "null"], ["", "x", ""]),
    (["", "", ""], ["", "", ""]),
    (["a,b", "N/A", "None"], ["a,b", "", ""])])
def test_text_cells_read_missing_cells_as_pandas_does(tmp_path, cells,
                                                      want):
    """A text column whose cells pandas reads as missing (its default
    ``na_values``; all of them: a float column of NaN) comes out as
    ``fillna("")`` gives it after pandas' reader."""
    import pandas as pd

    path = str(tmp_path / "t.csv")
    write_csv_columns(path, {"t": np.array(cells, dtype=object),
                             "y": np.arange(3.0)})
    assert pd.read_csv(path)["t"].fillna("").tolist() == want
    assert text_cells(read_csv_columns(path)["t"]) == want


def test_synthetic_and_retrieved_csvs_are_byte_equal(tmp_path):
    kw = dict(num_rows=300, num_reviewers=25, num_items=9, seed=4)
    a = jaf.synthetic_amazon_fashion(str(tmp_path / "jax.csv"), **kw)
    b = af.synthetic_amazon_fashion(str(tmp_path / "port.csv"), **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    rows = [{"overall": 5.0, "verified": True, "reviewerID": "A1",
             "asin": "B01", "reviewText": 'Nice, "soft"\nfabric',
             "summary": "Five Stars", "unixReviewTime": 1500000000,
             "vote": "1,234"},
            {"overall": 2.0, "verified": False, "reviewerID": "A2",
             "asin": "B02", "unixReviewTime": 1500000100},
            {"overall": 4.0, "reviewerID": "A1", "asin": "B02",
             "reviewText": None, "summary": "ok", "unixReviewTime": 1,
             "vote": "3"}]
    src = tmp_path / "reviews.json"
    src.write_text("".join(json.dumps(r) + "\n" for r in rows))
    a = jaf.retrieve_dataset(str(src), str(tmp_path / "jax_r.csv"))
    b = af.retrieve_dataset(str(src), str(tmp_path / "port_r.csv"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert os.path.getsize(b) > 0


# -- the attention cores' shared-memory budget ------------------------------

#: half an H100's SM less the runtime's 1 kB a block: two blocks an SM
H100_HALF = H100_SM // 2 - 1024


@pytest.mark.parametrize("row,budget", [
    (99_328, H100_HALF),     # finetune_llm's forward row, 128x64x128/4
    (134_144, H100_BLOCK),   # its backward row: past half an SM
    (68_608, H100_HALF),     # the downstream LM's backward row, C = 64
    (H100_HALF, H100_HALF), (H100_HALF + 1, H100_BLOCK),
    (H100_BLOCK, H100_BLOCK),
    (408_720, H100_BLOCK),   # S = 195 at C = 128, 4 heads, backward
    (414_960, H100_BLOCK),   # and at 8 heads
    (H100_BLOCK + 1, H100_BLOCK)])
def test_core_budget_admits_the_lm_rows_at_one_block_an_sm(row, budget):
    """The LM rows of ``cli/finetune_llm.py`` (S = 64 at C = 128, 4 heads:
    134,144 bytes a row backward) pass half an SM (115,712), so their
    core runs one block an SM (232,448); rows that fit half an SM keep
    that budget (and so their plan); S = 195 at C = 128 fits neither, nor
    does a byte past a block. Bytes a row as the CUDA library gives them
    (``kernel_text`` prints them on the card)."""
    assert H100_HALF == 115_712
    assert ca.core_budget(row, H100_BLOCK, H100_SM) == budget
    assert (row <= budget) == (row <= H100_BLOCK)


def test_core_max_s_walks_to_the_longest_row_that_fits():
    """:func:`core_max_s` over a row of 1,000 forward and 2,000 backward
    bytes a token: one block an SM takes 116 tokens (2,000 × 116 ≤
    232,448), half an SM 57; a card whose block is half an SM keeps that;
    a row that fits no budget past S = 16 leaves the short cores' 16."""
    def row_bytes(s, c, h):
        assert (c, h) == (128, 4)
        return 1_000 * s, 2_000 * s

    assert ca.core_max_s(128, 4, H100_BLOCK, H100_SM, row_bytes) == 116
    assert ca.core_max_s(128, 4, H100_HALF, H100_SM, row_bytes) == 57
    assert ca.core_max_s(128, 4, 30_000, 60_000, row_bytes) == 16
