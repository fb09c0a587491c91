"""The text slice's trainers and entry points on the CPU:
``train/downstream_text.py`` (both text paths), ``cli/downstream_llm.py``
and ``cli/finetune_llm.py``.

* Three steps each of the frozen and finetune downstream paths and of
  ``finetune_llm`` against the JAX package's record
  (``tests/fixtures/torch_port/text_record.npz``, written by
  ``tools/make_torch_port_text_fixture.py``) through
  ``chip_smoke.replay_text_part``, which the card's ``text_parity`` phase
  runs: ``convert.check_record``'s float32 limits (each loss 1e-4
  relative at step 1 and 1e-3 after, parameters 6.05·lr, each component's
  median 0.05·lr), the start's predictions within 1e-3 (relative past
  1; ``chip_smoke.SCORE_TOL``), ``finetune_llm``'s eval MSE within the
  loss limits.
* The validation RMSE of both paths from the same randomized weights as
  ``rmm_tpu``'s trainer computes it, 1e-5 relative.
* The CLIs for an epoch with ``--device cpu``; ``--save_model`` read back
  (the same predictions, bit for bit); any ``--text_model`` but
  ``hashing`` refused by name; the default device refused without CUDA.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rmm_tpu.datasets import amazon_fashion as jaf
from rmm_tpu.frame.stype import Stype as JStype
from rmm_tpu.train.downstream_text import \
    TextTabularRegressionTrainer as JaxTrainer
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.cli import downstream_llm, finetune_llm
from rmm_tpu_torch.convert import from_jax, load_record, text_variables
from rmm_tpu_torch.datasets.amazon_fashion import AmazonFashionDataset
from rmm_tpu_torch.frame.stype import Stype
from rmm_tpu_torch.nn.text import TextToEmbeddingFinetune
from rmm_tpu_torch.train.downstream_text import (
    TextTabularRegressionTrainer, constant_rmse)
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import one_torch_thread, \
    randomize_jax_variables  # noqa: F401

REC = load_record(chip_smoke.TEXT_FIXTURE)
ST = json.loads(str(REC["settings"]))
KW = dict(model="fttransformer", batch_size=64, n_hidden=16, n_gnn_layers=2,
          dropout=0.0, lr=1e-3, epochs=1)


@pytest.fixture(scope="module")
def reviews(tmp_path_factory):
    return jaf.synthetic_amazon_fashion(
        str(tmp_path_factory.mktemp("text") / "reviews.csv"), num_rows=400,
        num_reviewers=40, num_items=20, seed=2)


@pytest.mark.parametrize("name", ["frozen", "finetune", "finetune_llm"])
def test_three_steps_match_the_record(tmp_path, name):
    part = chip_smoke.replay_text_part(REC, ST, str(tmp_path), name, "cpu")
    assert len(part["terms"]) == ST["steps"]
    assert part["param_max_abs_err"] <= part["param_tol"]


def test_the_record_starts_from_the_ports_layout():
    """Every variable of the record's runs is one of the port's modules'
    parameters, with its shape: the LM's ``tok_emb``, ``pos_emb``,
    ``layer_0`` and LoRA ``lora_out`` (kernel, bias, ``lora_a``,
    ``lora_b``) under the encoder's ``text_model``, and
    ``finetune_llm``'s ``encoder`` and ``{"w", "b"}`` head."""
    lm = ST["runs"]["finetune"]["shapes"]
    assert lm["params/encoder/text_model/lora_out/lora_a"] == [16, 8]
    assert lm["params/encoder/text_model/tok_emb/embedding"] == [8192, 16]
    assert lm["params/encoder/text_tokenized/weight"] == [2, 16, 16]
    llm = ST["runs"]["finetune_llm"]["shapes"]
    assert llm["params/encoder/pos_emb"] == [64, 16]
    assert "params/encoder/layer_1/self_attn/qkv_kernel" in llm


@pytest.mark.parametrize("finetune", [False, True],
                         ids=["frozen", "finetune"])
def test_evaluation_matches_jax(reviews, finetune):
    stype = "text_tokenized" if finetune else "text_embedded"
    jds = jaf.AmazonFashionDataset(reviews, text_stype=JStype[stype],
                                   channels=16)
    jtr = JaxTrainer(JaxConfig(data=reviews, **KW), jds,
                     finetune_text=finetune, lora_rank=4)
    jtr.params = jax.tree_util.tree_map(
        jnp.asarray, randomize_jax_variables(jtr.params, 3))
    ds = AmazonFashionDataset(reviews, text_stype=Stype[stype])
    tr = TextTabularRegressionTrainer(Config(data=reviews, **KW,
                                             device="cpu"), ds,
                                      finetune_text=finetune, lora_rank=4)
    tr.model.load_state_dict(from_jax(text_variables(
        jax.tree_util.tree_map(np.asarray, jtr.params)), tr.model))
    for jview, view in zip(jds.edges.split()[1:], ds.edges.split()[1:]):
        np.testing.assert_allclose(tr.evaluate(view), jtr.evaluate(jview),
                                   rtol=1e-5)


def test_the_text_lm_has_the_references_fixed_widths(reviews):
    ds = AmazonFashionDataset(reviews, text_stype=Stype.text_tokenized)
    tr = TextTabularRegressionTrainer(Config(data=reviews, **KW,
                                             device="cpu"), ds,
                                      finetune_text=True)
    lm = tr.model.encoder.text_model
    assert isinstance(lm, TextToEmbeddingFinetune)
    assert lm.num_layers == 1 and lm.lora_out.rank == 8
    attn = lm.layer_0.self_attn
    assert (attn.nhead, attn.dropout) == (4, 0.1)
    assert tr.model.model.backbone.layer_0.self_attn.nhead == 8
    # AdamW decays every parameter, the 1-D ones too
    (group,) = tr.optimizer.param_groups
    assert group["weight_decay"] == 1e-3
    assert len(group["params"]) == len(list(tr.model.parameters()))


def argv(csv, wandb, *extra):
    return ["--dataset", csv, "--epochs", "1", "--testing", "--device",
            "cpu", "--channels", "16", "--batch_size", "64", "--wandb_dir",
            wandb, *extra]


@pytest.mark.parametrize("path", ["frozen", "finetune"])
def test_downstream_cli_trains_an_epoch_on_the_cpu(reviews, tmp_path, path):
    stats = {}
    history, best = downstream_llm.main(
        argv(reviews, str(tmp_path), "--text_path", path), stats)
    (rec,) = history
    assert stats["run_dir"] == os.path.join(str(tmp_path),
                                            "run_downstream_llm")
    assert os.path.exists(os.path.join(stats["run_dir"], "metrics.jsonl"))
    assert stats["device"] == "cpu" and sum(stats["split_rows"]) == 400
    assert rec["steps"] == -(-stats["split_rows"][0] // 64)
    assert len(stats["step_losses"]) == rec["steps"]
    assert all(np.isfinite([rec["loss"], rec["val_rmse"], rec["test_rmse"]]))
    assert best == rec["val_rmse"]
    assert set(stats["constant_rmse"]) == {"val", "test"}
    ds = AmazonFashionDataset(reviews)
    assert stats["constant_rmse"] == constant_rmse(ds)
    for key in ("data_load", "transfer", "step"):
        assert rec[key] >= 0


def test_finetune_llm_saves_and_reloads(reviews, tmp_path):
    export = str(tmp_path / "export")
    history, model = finetune_llm.finetune_llm(
        reviews, epochs=1, batch_size=32, hidden=16, num_layers=1,
        lora_rank=4, device="cpu", save_model=export)
    (rec,) = history
    assert rec["steps"] == int(400 * 0.8) // 32
    assert np.isfinite(rec["train_mse"]) and np.isfinite(rec["eval_mse"])
    back = finetune_llm.load_finetuned(export)
    assert not back.training
    want = model.state_dict()
    for k, v in back.state_dict().items():
        assert torch.equal(v, want[k]), k
    ids, y = finetune_llm.read_dataset(reviews)
    _, _, te_idx = finetune_llm.split(len(y), 0)
    got = finetune_llm.eval_mse(back, torch.from_numpy(ids), y, te_idx, 32)
    assert got == rec["eval_mse"]


def test_finetune_llm_cli_runs_on_the_cpu(reviews, tmp_path):
    stats = {}
    history = finetune_llm.main(
        ["--dataset", reviews, "--epochs", "1", "--hidden", "16",
         "--num_layers", "1", "--batch_size", "64", "--device", "cpu",
         "--wandb_dir", str(tmp_path), "--save_model",
         str(tmp_path / "export")], stats)
    assert [h["epoch"] for h in history] == [0]
    assert os.path.exists(os.path.join(str(tmp_path), "run_finetune_llm",
                                       "metrics.jsonl"))
    assert os.path.exists(str(tmp_path / "export" / "final" / "model.pt"))


def test_the_llm_data_reads_as_the_reference_reads_it(reviews):
    from rmm_tpu.cli.finetune_llm import read_dataset as jax_read

    want_ids, want_y = jax_read(reviews)
    ids, y = finetune_llm.read_dataset(reviews)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(y, want_y)


@pytest.mark.parametrize("cli", ["downstream_llm", "finetune_llm"])
def test_other_text_models_are_refused_by_name(reviews, tmp_path, cli):
    args = ["--dataset", reviews, "--device", "cpu", "--wandb_dir",
            str(tmp_path), "--text_model", "sentence-transformers/x"]
    main = downstream_llm.main if cli == "downstream_llm" \
        else finetune_llm.main
    with pytest.raises(ValueError, match="'sentence-transformers/x' is not "
                       "ported"):
        main(args)


@pytest.mark.parametrize("cli", ["downstream_llm", "finetune_llm"])
def test_clis_need_cuda_unless_asked_for_cpu(reviews, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    main = downstream_llm.main if cli == "downstream_llm" \
        else finetune_llm.main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--dataset", reviews, "--wandb_dir", str(tmp_path)])
