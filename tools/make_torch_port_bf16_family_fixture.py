"""Write the JAX record of ``--precision bf16`` across the model menu, the
node tasks, the masked-cell task and the tabular and text trainers that
the PyTorch port is held against: ``tests/test_torch_bf16_families.py`` on
the CPU and ``chip_smoke.py``'s ``bf16_family_parity`` phase on the GPU
(where there is no JAX, so it reads this record).

On the CPU, with ``rmm_tpu``, every run under ``precision="bf16"`` with
dropout 0, at C = 16, 2 layers, fanouts 8/8, batch 32:

1. each family (``fttransformer``, ``gin``, ``pna``, ``cpna``,
   ``cpnatab``, ``tabgnninterleaved``) with ``--emlps`` on the 1,000-row
   synthetic AML of ``bf16_tiny_record.npz`` (edge classification);
2. ``tabgnn`` and ``pna`` node classification on a 400-account Ethereum
   phishing cut (8 features: S = 9; edges with timestamps) and on a
   300-developer MUSAE GitHub cut (128 features: node tokens S = 129, the
   long cores; edges without a float32 block, so bf16 messages reach the
   segment sums);
3. ``pna`` on ``mcm_edge_table`` on the AML data;
4. the tabular MCM trainer (C = 16, 2 layers, batch 64) on the AML data;
5. the downstream text trainer, frozen and finetune (the text record's
   600 reviews, C = 16; the LM's rows 64 tokens), its LM's fixed dropout
   at 0 as ``tools/make_torch_port_text_fixture.py`` takes it.

Each run starts from ``rmm_tpu_torch.convert.random_variables`` over its
variables' shapes (which the record stores) and records the start's
outputs on one evaluated batch (the served seed ids and logits; the MCM
outputs; the predicted ratings), three train steps on the first three
train batches of epoch 0 (each loss term and, after step 3, each
variable's seeded sample of 64 entries, its sum and its norm, in
``convert.pack_record``'s layout) and the parameters that no step moved.

Every run is eager (``jax.disable_jit()``): op by op, each bf16 operation
rounded where the reference's modules round it, as the port rounds. A
jitted bf16 step lets XLA fuse bf16 operations and skip roundings between
them, which moved the AML runs' node-encoder medians by 0.16-0.57·lr and
cpnatab's step-3 loss by 3e-2 against the same eager port (the jitted
records of ``tools/make_torch_port_bf16_fixture.py`` carry limits widened
for it); eager, they land at 0.004-0.055·lr and 7e-4.

The attention takes the Pallas kernel in interpret mode
(``tests.torch_port_util.jax_kernel_attention``), the segment sums the
scatter path (``RMM_SEGMENT_IMPL=scatter``), which adds bf16 data in bf16.
The port adds in float32, so each GNN run is taken a second time with the
reference's sums in float32
(``tests.torch_port_util.jax_float32_segment_sums``). How far that run
lands from the record by ``convert.check_record``'s measures is stored in
the settings (``sums_gap``): the measured distance the record's bf16-sum
limits (``convert.BF16_SUMS_*``) are set from. Where it is not zero (the
run feeds bf16 messages to the sums), the run's arrays go into the record
too, under ``<run>/f32sums/``, and the port is held to them at the plain
bf16 limits.

    JAX_PLATFORMS=cpu python tools/make_torch_port_bf16_family_fixture.py

About 25 minutes and 3 GB of memory; ``--runs a,b`` takes some runs and
prints them without writing. This tool imports both packages; it is not
part of the port.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["RMM_SEGMENT_IMPL"] = "scatter"   # read when a step traces
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import make_torch_port_ssl_fixture as ssl_fixture  # noqa: E402
import make_torch_port_text_fixture as text_fixture  # noqa: E402
from rmm_tpu.datasets import (IBMTransactionsAML, build_dataset,  # noqa: E402
                              write_synthetic_aml_csv)
from rmm_tpu.datasets.amazon_fashion import (  # noqa: E402
    AmazonFashionDataset, synthetic_amazon_fashion)
from rmm_tpu.datasets.base import PretrainType  # noqa: E402
from rmm_tpu.datasets.synthetic import write_synthetic_node_dataset  # noqa: E402
from rmm_tpu.frame.stype import Stype  # noqa: E402
from rmm_tpu.train import downstream_text  # noqa: E402
from rmm_tpu.train.tabular import TabularMCMTrainer  # noqa: E402
from rmm_tpu.train.trainer import Trainer  # noqa: E402
from rmm_tpu.utils.config import Config, config_from_args, create_parser  # noqa: E402
from rmm_tpu.utils.precision import compute_cast, out_f32  # noqa: E402
from rmm_tpu_torch.convert import (Record, check_record,  # noqa: E402
                                   flatten_variables, loss_terms,
                                   pack_record, random_variables,
                                   tabular_variables, text_variables,
                                   torch_key)
from rmm_tpu_torch.train.trainer import MCM_SUMS  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    jax_cpnatab_without_row_dropout, jax_float32_segment_sums,
    jax_kernel_attention, nest)

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
RECORD = os.path.join(FIXTURES, "bf16_family_record.npz")
AML = dict(rows=1000, num_accounts=62, data_seed=3)
#: the node datasets: (family, directory, nodes, edges, features, classes)
NODE_DATA = {
    "eth": ("eth", "ethereum-phishing", 400, 1824, 8, 2),
    "musae": ("musae", "musae-github", 300, 2300, 128, 2),
}
SPEC = dict(n_hidden=16, n_gnn_layers=2, num_neighs=[8, 8], batch_size=32,
            sample=64, data_seed=4)
FAMILIES = ("fttransformer", "gin", "pna", "cpna", "cpnatab",
            "tabgnninterleaved")
#: the trainer runs: name → (data, model, task, extra flags)
RUNS = {
    **{f"fam_{m}": ("aml", m, "edge_classification", ["--emlps"])
       for m in FAMILIES},
    **{f"{d}_{m}": (d, m, "node_classification", [])
       for d in NODE_DATA for m in ("tabgnn", "pna")},
    "mcm_pna": ("aml", "pna", "mcm_edge_table", ["--emlps"]),
}
TABULAR = dict(channels=16, num_layers=2, batch_size=64, lr=2e-4,
               weight_decay=1e-3, adam_eps=1e-8)
TEXT_RUNS = ("text_frozen", "text_finetune")
STEPS, SEED, VAR_SEED, OUT_ROWS = 3, 1, 71, 64


def run_argv(root: str, name: str) -> list:
    """The CLI flags of a trainer run (the port's replay parses the
    same, with ``--device``)."""
    _, model, task, extra = RUNS[name]
    return ["--data", root, "--model", model, "--task", task,
            "--n_hidden", str(SPEC["n_hidden"]), "--n_gnn_layers",
            str(SPEC["n_gnn_layers"]), "--num_neighs",
            *map(str, SPEC["num_neighs"]), "--batch_size",
            str(SPEC["batch_size"]), "--seed", str(SEED), "--precision",
            "bf16", *extra]


def eval_outputs(tr: Trainer, gb) -> list:
    """The start's float32 outputs on a batch, as the JAX trainer's
    ``_forward_eval`` computes them (eager)."""
    v = tr.variables
    out = tr.model.apply(
        {"params": compute_cast(v["params"], "bf16"),
         **{k: x for k, x in v.items() if k != "params"}},
        compute_cast(tr.edge_table, "bf16"),
        compute_cast(tr.node_table, "bf16"), gb, False)
    out = out_f32(out)
    return [np.asarray(out[0])] + [np.asarray(c) for c in out[1]] \
        if isinstance(out, tuple) else [np.asarray(out)]


def trainer_run(name: str, root: str) -> tuple[dict, dict, dict]:
    """One trainer run's record arrays (under ``<name>/``), settings and
    flat variables after the steps."""
    _, model, task, _ = RUNS[name]
    cfg = config_from_args(create_parser().parse_args(
        run_argv(root, name))).replace(dropout=0.0, sampler="host")
    ds = build_dataset(cfg)
    if task == "node_classification":
        cfg = cfg.replace(n_classes=ds.n_classes)
    tr = Trainer(cfg, ds)
    shapes = {k: list(np.shape(v))
              for k, v in flatten_variables(tr.variables).items()}
    start = random_variables(shapes, VAR_SEED)
    tr.variables = jax.tree_util.tree_map(jnp.asarray, nest(start))
    tr.opt_state = tr.tx.init(tr.variables["params"])
    table = ds.nodes if task == "node_classification" else ds.edges
    train, val, test = table.split()
    p = f"{name}/"
    gb = next(tr._batches(val if task == "mcm_edge_table" else test,
                          "val" if task == "mcm_edge_table" else "test"))
    outs = eval_outputs(tr, gb)
    arrays = {}
    if task == "mcm_edge_table":
        arrays[f"{p}out/num"] = outs[0][:OUT_ROWS].astype(np.float32)
        for i, c in enumerate(outs[1:]):
            arrays[f"{p}out/cat_{i}"] = c[:OUT_ROWS].astype(np.float32)
    else:
        keep = np.asarray(gb.seed_mask)
        gather = gb.node_gather if task == "node_classification" \
            else gb.edge_gather
        arrays[f"{p}serve/id"] = np.asarray(gather)[
            :cfg.batch_size][keep].astype(np.int64)
        arrays[f"{p}serve/logits"] = outs[0][keep].astype(np.float32)
    terms = []
    key = jax.random.PRNGKey(0)
    for gb in itertools.islice(tr._batches(train, "train", 0), STEPS):
        tr.variables, tr.opt_state, loss, aux = tr._train_step(
            tr.variables, tr.opt_state, gb, key, tr.edge_table,
            tr.node_table)
        sums = ({k: float(aux[k]) for k in MCM_SUMS}
                if task == "mcm_edge_table" else {})
        terms.append(loss_terms(loss, sums))
    after = flatten_variables(jax.device_get(tr.variables))
    arrays.update({f"{p}term/{k}": np.asarray([t[k] for t in terms],
                                              np.float64)
                   for k in terms[0]})
    arrays.update(ssl_fixture.sampled(after, p, SPEC["sample"]))
    return arrays, {
        "kind": "trainer", "data": RUNS[name][0], "model": model,
        "task": task, "flags": RUNS[name][3], "lr": cfg.lr,
        "n_classes": cfg.n_classes, "edge_capacity": tr.cfg.edge_capacity,
        "node_capacity": tr.cfg.node_capacity, "shapes": shapes,
        "unmoved": unmoved(after, start), "terms": terms}, after


def unmoved(after: dict, start: dict) -> list:
    return sorted(k for k in after if k.startswith("params/")
                  and np.array_equal(after[k], start[k]))


def tabular_run(csv: str) -> tuple[dict, dict, dict]:
    t = TABULAR
    cfg = Config(model="fttransformer", data=csv, batch_size=t["batch_size"],
                 n_hidden=t["channels"], n_gnn_layers=t["num_layers"],
                 dropout=0.0, lr=t["lr"], weight_decay=t["weight_decay"],
                 adam_eps=t["adam_eps"], seed=SEED, precision="bf16")
    ds = IBMTransactionsAML(root=csv, pretrain={PretrainType.MASK},
                            channels=cfg.n_hidden)
    tr = TabularMCMTrainer(cfg, ds.edges)
    layout = flatten_variables(tabular_variables(tr.params))
    shapes = {k: list(np.shape(v)) for k, v in layout.items()}
    start = random_variables(shapes, VAR_SEED)
    flat = nest(start)["params"]
    tr.params = jax.tree_util.tree_map(jnp.asarray, {
        "encoder": {"params": flat["edge_encoder"]},
        "model": {"params": flat["model"]},
        "head": {"params": flat["head"]}})
    tr.opt_state = tr.tx.init(tr.params)
    train, val, _ = ds.edges.split()
    p = "tabular/"
    tf, _ = next(iter(tr._loader(val, False)))
    num_out, cat_out, _ = tr._fwd(tr.params, tf)
    arrays = {f"{p}out/num": np.asarray(num_out, np.float32)[:OUT_ROWS]}
    for i, c in enumerate(cat_out):
        arrays[f"{p}out/cat_{i}"] = np.asarray(c, np.float32)[:OUT_ROWS]
    terms = []
    for tf, valid in itertools.islice(tr._loader(train, True, 0), STEPS):
        mask = np.zeros(cfg.batch_size, bool)
        mask[:valid] = True
        tr.params, tr.opt_state, loss, aux = tr._train_step(
            tr.params, tr.opt_state, tf, mask, jax.random.PRNGKey(0))
        terms.append(loss_terms(loss, {k: float(aux[k])
                                       for k in MCM_SUMS}))
    after = flatten_variables(jax.device_get(tabular_variables(tr.params)))
    arrays.update({f"{p}term/{k}": np.asarray([x[k] for x in terms])
                   for k in terms[0]})
    arrays.update(ssl_fixture.sampled(after, p, SPEC["sample"]))
    return arrays, {"kind": "tabular", **t, "shapes": shapes,
                    "terms": terms, "unmoved": unmoved(after, start)}, after


def text_run(csv: str, finetune: bool) -> tuple[dict, dict, dict]:
    d = text_fixture.DOWNSTREAM
    cfg = Config(model="fttransformer", data=csv, batch_size=d["batch_size"],
                 n_hidden=d["channels"], n_gnn_layers=d["num_layers"],
                 dropout=0.0, lr=d["lr"], seed=SEED, epochs=1,
                 precision="bf16")
    ds = AmazonFashionDataset(
        root=csv, text_stype=(Stype.text_tokenized if finetune
                              else Stype.text_embedded),
        channels=cfg.n_hidden)
    with mock.patch.object(downstream_text, "TextToEmbeddingFinetune",
                           text_fixture.lm_without_dropout()):
        tr = downstream_text.TextTabularRegressionTrainer(
            cfg, ds, finetune_text=finetune, lora_rank=d["lora_rank"])
    layout = flatten_variables(text_variables(tr.params))
    shapes = {k: list(np.shape(v)) for k, v in layout.items()}
    start = random_variables(shapes, VAR_SEED)
    tr.params = jax.tree_util.tree_map(
        jnp.asarray, {k: {"params": v}
                      for k, v in nest(start)["params"].items()})
    tr.opt_state = tr.tx.init(tr.params)
    train, val, _ = ds.edges.split()
    p = "text_finetune/" if finetune else "text_frozen/"
    tf, _ = next(iter(downstream_text.DataLoader(val.tensor_frame,
                                                 cfg.batch_size)))
    arrays = {f"{p}out/pred": np.asarray(tr._fwd(tr.params, tf),
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
    arrays.update(ssl_fixture.sampled(after, p, SPEC["sample"]))
    return arrays, {"kind": "text", "finetune": finetune, **d,
                    "shapes": shapes, "terms": [{"loss": x} for x in losses],
                    "unmoved": unmoved(after, start)}, after


def sums_gap(name: str, root: str, arrays: dict,
             run: dict) -> tuple[dict, dict]:
    """The run again with the reference's sums in float32: its arrays
    (under ``<run>/f32sums/``) and how far it lands from the record's
    arrays by ``check_record``'s measures (default limits, so the faults
    list says nothing; the errors are what count)."""
    with jax_float32_segment_sums():
        twin, info, after = trainer_run(name, root)
    state = {}
    for path, arr in after.items():
        key, transpose = torch_key(path)
        state[key] = torch.from_numpy(np.array(arr.T if transpose else arr))
    rec = Record(arrays)
    _, summary = check_record(state, info["terms"], rec, f"{name}/",
                              run["lr"], STEPS, SPEC["n_hidden"])
    out_key = next(k for k in arrays if "/serve/logits" in k
                   or k.endswith("/out/num"))
    want = arrays[out_key]
    summary["out_max_err"] = float(np.abs(twin[out_key] - want).max()
                                   / max(1.0, float(np.abs(want).max())))
    summary["param_median_lr"] = {
        k: v / run["lr"] for k, v in summary["param_median_abs_err"].items()}
    p = f"{name}/"
    return summary, {f"{p}f32sums/{k[len(p):]}": v for k, v in twin.items()}


def data_roots(workdir: str) -> dict:
    roots = {"aml": write_synthetic_aml_csv(
        os.path.join(workdir, f"bf16_aml_{AML['rows']}.csv"),
        num_rows=AML["rows"], num_accounts=AML["num_accounts"],
        seed=AML["data_seed"])}
    for name, (family, dirname, nodes, edges, feats, classes) in \
            NODE_DATA.items():
        roots[name] = os.path.join(workdir, f"bf16_{dirname}_{nodes}")
        write_synthetic_node_dataset(
            roots[name], family=family, num_nodes=nodes, num_edges=edges,
            num_feats=feats, n_classes=classes, seed=SPEC["data_seed"])
    d = text_fixture.DATA
    roots["text"] = synthetic_amazon_fashion(
        os.path.join(workdir, "bf16_amazon_fashion.csv"),
        num_rows=d["rows"], num_reviewers=d["reviewers"],
        num_items=d["items"], seed=d["seed"])
    return roots


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--runs", default=None,
                   help="comma-separated runs; printed, not written")
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    roots = data_roots(args.workdir)
    names = (list(RUNS) + ["tabular", *TEXT_RUNS] if args.runs is None
             else args.runs.split(","))
    arrays, runs = {}, {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax_cpnatab_without_row_dropout())
        stack.enter_context(jax_kernel_attention())
        stack.enter_context(jax.disable_jit())
        for name in names:
            if name == "tabular":
                a, runs[name], _ = tabular_run(roots["aml"])
            elif name in TEXT_RUNS:
                a, runs[name], _ = text_run(roots["text"],
                                            name == "text_finetune")
            else:
                root = roots[RUNS[name][0]]
                a, runs[name], _ = trainer_run(name, root)
                if RUNS[name][1] != "fttransformer":
                    gap, twin = sums_gap(name, root, a, runs[name])
                    runs[name]["sums_gap"] = gap
                    if gap["param_max_abs_err"] > 0:
                        a.update(twin)
            arrays.update(a)
            print(json.dumps({"run": name, "terms": runs[name]["terms"],
                              "sums_gap": runs[name].get("sums_gap")}),
                  flush=True)
    if args.runs is not None:
        return
    settings = dict(SPEC, aml=AML, node_data={k: dict(zip(
        ("family", "dir", "nodes", "edges", "num_feats", "n_classes"), v))
        for k, v in NODE_DATA.items()}, text_data=text_fixture.DATA,
        runs=runs, steps=STEPS, epoch=0, seed=SEED, var_seed=VAR_SEED,
        dropout=0.0, nhead=8, precision="bf16", segment_impl="scatter",
        attention="pallas interpret", jit=False, out_rows=OUT_ROWS)
    np.savez_compressed(RECORD, **pack_record(arrays),
                        settings=np.array(json.dumps(settings)))
    print(json.dumps({"record": os.path.relpath(RECORD, ROOT),
                      "bytes": os.path.getsize(RECORD)}))


if __name__ == "__main__":
    main()
