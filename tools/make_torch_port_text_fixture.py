"""Write the JAX record of the text slice that the PyTorch port is held
against: ``tests/test_torch_text_train.py`` on the CPU and
``chip_smoke.py``'s ``text_parity`` phase on the GPU (where there is no
JAX, so it reads this record).

On the CPU, with ``rmm_tpu``, three train steps (dropout 0) of each of:

1. ``frozen/``: ``rmm_tpu.train.downstream_text.TextTabularRegressionTrainer``
   on the frozen path (the hashing embedder's 128-wide vectors);
2. ``finetune/``: the same trainer with the text LM inside the forward
   (``finetune_text=True``, LoRA rank 8; the LM's fixed dropout of 0.1
   set to 0 for the run), both at C = 16, 2 layers, batch 64, lr 1e-3,
   on a synthetic Amazon Fashion of 600 reviews (60 reviewers, 30 items,
   data seed 0), the first three shuffled train batches of epoch 0;
3. ``finetune_llm/``: ``rmm_tpu.cli.finetune_llm.finetune_llm`` itself at
   hidden 16, 2 layers, LoRA rank 8, max_length 64 (the LM's rows are 64
   tokens, the long attention cores on the card), dropout 0, on 80
   reviews (data seed 1): 64 train rows and a batch of 64, so each of its
   three epochs is one step, whose loss the epoch's ``train_mse`` is.

The trainers start from ``rmm_tpu_torch.convert.random_variables`` over
the variables' shapes in the port's module layout (which the record
stores, so the port rebuilds the same start); ``finetune_llm``'s LM starts
there too and its head at zero, as the CLI's does. The record holds each
step's loss, the start's predictions on the first 64 rows of the first
validation batch (``frozen``, ``finetune``) or each epoch's eval MSE
(``finetune_llm``), and after step 3 each variable's seeded sample of 16
entries, sum and norm (``convert.check_record`` reads them).

    JAX_PLATFORMS=cpu python tools/make_torch_port_text_fixture.py

The record is ``tests/fixtures/torch_port/text_record.npz``. About a
minute on the CPU. This tool imports both packages; it is not part of the
port.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import make_torch_port_ssl_fixture as ssl_fixture  # noqa: E402
from rmm_tpu.cli import finetune_llm as jax_finetune_llm  # noqa: E402
from rmm_tpu.datasets.amazon_fashion import (  # noqa: E402
    AmazonFashionDataset, synthetic_amazon_fashion)
from rmm_tpu.frame.stype import Stype  # noqa: E402
from rmm_tpu.nn.text import TextToEmbeddingFinetune  # noqa: E402
from rmm_tpu.train import downstream_text  # noqa: E402
from rmm_tpu.utils.config import Config  # noqa: E402
from rmm_tpu_torch.convert import (finetune_llm_variables,  # noqa: E402
                                   flatten_variables, pack_record,
                                   random_variables, text_variables)
from tests.torch_port_util import nest  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
RECORD = os.path.join(FIXTURES, "text_record.npz")
DATA = dict(rows=600, reviewers=60, items=30, seed=0)
DOWNSTREAM = dict(channels=16, num_layers=2, batch_size=64, lr=1e-3,
                  lora_rank=8)
LLM_DATA = dict(rows=80, reviewers=20, items=10, seed=1)
LLM = dict(hidden=16, num_layers=2, lora_rank=8, max_length=64,
           batch_size=64, lr=1e-3, seed=0)
STEPS, SEED, VAR_SEED, SAMPLE, OUT_ROWS = 3, 1, 29, 16, 64


def lm_without_dropout():
    """The JAX LM with its fixed dropout 0.1 at 0, as the port's parity
    runs take it (``nn.dropout.set_rate``)."""
    class NoDropout(TextToEmbeddingFinetune):
        dropout: float = 0.0
    return NoDropout


def run_downstream(csv: str, finetune: bool) -> tuple[dict, dict]:
    d = DOWNSTREAM
    cfg = Config(model="fttransformer", data=csv, batch_size=d["batch_size"],
                 n_hidden=d["channels"], n_gnn_layers=d["num_layers"],
                 dropout=0.0, lr=d["lr"], seed=SEED, epochs=1)
    ds = AmazonFashionDataset(
        root=csv, text_stype=(Stype.text_tokenized if finetune
                              else Stype.text_embedded),
        channels=cfg.n_hidden)
    with mock.patch.object(downstream_text, "TextToEmbeddingFinetune",
                           lm_without_dropout()):
        tr = downstream_text.TextTabularRegressionTrainer(
            cfg, ds, finetune_text=finetune, lora_rank=d["lora_rank"])
    layout = flatten_variables(text_variables(tr.params))
    shapes = {k: list(np.shape(v)) for k, v in layout.items()}
    start = nest(random_variables(shapes, VAR_SEED))["params"]
    tr.params = jax.tree_util.tree_map(
        jnp.asarray, {k: {"params": v} for k, v in start.items()})
    tr.opt_state = tr.tx.init(tr.params)
    train, val, _ = ds.edges.split()
    p = "finetune/" if finetune else "frozen/"
    tf, _ = next(iter(downstream_text.DataLoader(val.tensor_frame,
                                                 cfg.batch_size)))
    arrays = {f"{p}out/pred": np.asarray(tr._eval_step(tr.params, tf),
                                         np.float32)[:OUT_ROWS]}
    losses = []
    loader = downstream_text.DataLoader(train.tensor_frame, cfg.batch_size,
                                        shuffle=True, seed=cfg.seed)
    for tf, valid in itertools.islice(loader, STEPS):
        mask = np.zeros(cfg.batch_size, bool)
        mask[:valid] = True
        tr.params, tr.opt_state, loss = tr._train_step(
            tr.params, tr.opt_state, jax.device_put(tf), mask,
            jax.random.PRNGKey(0))
        losses.append(float(loss))
    after = flatten_variables(jax.device_get(text_variables(tr.params)))
    arrays[f"{p}term/loss"] = np.asarray(losses)
    arrays.update(ssl_fixture.sampled(after, p, SAMPLE))
    return arrays, {"shapes": shapes, "losses": losses}


def run_finetune_llm(csv: str) -> tuple[dict, dict]:
    m = LLM
    shapes = {}

    class RandomStart(lm_without_dropout()):
        def init(self, *args, **kwargs):
            variables = super().init(*args, **kwargs)
            flat = flatten_variables({"params": {"encoder": variables[
                "params"]}})
            shapes.update((k, list(np.shape(v))) for k, v in flat.items())
            start = nest(random_variables(shapes, VAR_SEED))
            return {"params": jax.tree_util.tree_map(
                jnp.asarray, start["params"]["encoder"])}

    with mock.patch.object(jax_finetune_llm, "TextToEmbeddingFinetune",
                           RandomStart):
        history, params = jax_finetune_llm.finetune_llm(
            csv, epochs=STEPS, batch_size=m["batch_size"], lr=m["lr"],
            hidden=m["hidden"], num_layers=m["num_layers"],
            lora_rank=m["lora_rank"], max_length=m["max_length"],
            seed=m["seed"])
    assert all(h["epoch"] == i for i, h in enumerate(history))
    after = flatten_variables(jax.device_get(finetune_llm_variables(params)))
    p = "finetune_llm/"
    arrays = {f"{p}term/loss": np.asarray([h["train_mse"]
                                           for h in history]),
              f"{p}eval_mse": np.asarray([h["eval_mse"] for h in history])}
    arrays.update(ssl_fixture.sampled(after, p, SAMPLE))
    return arrays, {"shapes": shapes,
                    "losses": [h["train_mse"] for h in history],
                    "eval_mse": [h["eval_mse"] for h in history]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    csv = synthetic_amazon_fashion(
        os.path.join(args.workdir, "amazon_fashion.csv"),
        num_rows=DATA["rows"], num_reviewers=DATA["reviewers"],
        num_items=DATA["items"], seed=DATA["seed"])
    llm_csv = synthetic_amazon_fashion(
        os.path.join(args.workdir, "amazon_fashion_llm.csv"),
        num_rows=LLM_DATA["rows"], num_reviewers=LLM_DATA["reviewers"],
        num_items=LLM_DATA["items"], seed=LLM_DATA["seed"])
    arrays, runs = {}, {}
    for name, fn in (("frozen", lambda: run_downstream(csv, False)),
                     ("finetune", lambda: run_downstream(csv, True)),
                     ("finetune_llm", lambda: run_finetune_llm(llm_csv))):
        a, runs[name] = fn()
        arrays.update(a)
        print(json.dumps({"run": name, "losses": runs[name]["losses"]}),
              flush=True)
    settings = dict(data=DATA, downstream=DOWNSTREAM, llm_data=LLM_DATA,
                    llm=LLM, runs=runs, steps=STEPS, seed=SEED,
                    var_seed=VAR_SEED, dropout=0.0, lm_dropout=0.0,
                    out_rows=OUT_ROWS)
    np.savez_compressed(RECORD, **pack_record(arrays),
                        settings=np.array(json.dumps(settings)))
    print(json.dumps({"record": os.path.relpath(RECORD, ROOT),
                      "bytes": os.path.getsize(RECORD)}))


if __name__ == "__main__":
    main()
