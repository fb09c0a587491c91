"""Where the SSL parity margin comes from: the port's train-mode
``MaskedBatchNorm`` and PNA aggregation against the reference's, on the
node states of step 1 of ``chip_smoke.py``'s ``ssl_parity`` (the JAX
record ``tests/fixtures/torch_port/ssl_record.npz``: mcm-lp at C = 128, 3
layers, on the 4,096-row cut, dropout 0, from the record's start), on the
CPU.

The port's pretrainer takes the record's first batch in train mode (both
views, LP then MCM: 6 fused layers). Each layer's PNA messages and its
BatchNorm input are captured; then, on the same inputs, for each of the 6:

* BatchNorm: ``rmm_tpu``'s ``MaskedBatchNorm`` (train mode) and the
  port's, each against float64 of the same formula: the largest error of
  the output and of the new running mean and variance, and the smallest
  per-feature batch variance;
* PNA: ``rmm_tpu.ops.segment.pna_aggregate`` (its default path: sums as
  differences of one running float32 cumsum) and the port's (scatter
  sums), each against float64: the largest error of the mean and of the
  std block, beside the std block's scale.

One JSON line a layer, then the largest of each.

    JAX_PLATFORMS=cpu python tools/torch_bn_parity.py

This tool imports both packages; it is not part of the port.
"""
from __future__ import annotations

import itertools
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import rmm_tpu_torch.nn.gnn.conv as port_conv  # noqa: E402
from rmm_tpu.nn.norms import MaskedBatchNorm as JaxBatchNorm  # noqa: E402
from rmm_tpu.ops.segment import pna_aggregate as jax_pna  # noqa: E402
from rmm_tpu_torch.cli import fused  # noqa: E402
from rmm_tpu_torch.convert import from_jax, random_variables  # noqa: E402
from rmm_tpu_torch.datasets import build_dataset  # noqa: E402
from rmm_tpu_torch.nn.norms import MaskedBatchNorm  # noqa: E402
from rmm_tpu_torch.ops.segment import pna_aggregate  # noqa: E402
from rmm_tpu_torch.train.pretrain import PretrainTrainer  # noqa: E402


def batchnorm64(x, mask, weight, bias, mean0, var0, momentum=0.9,
                eps=1e-5):
    """The masked BatchNorm's train-mode formula in float64: (output, new
    running mean, new running variance)."""
    m = mask.astype(np.float64)[:, None]
    n = max(m.sum(), 1.0)
    mean = (x * m).sum(0) / n
    var = ((x - mean) ** 2 * m).sum(0) / n
    y = (x - mean) / np.sqrt(var + eps) * weight + bias
    return (y, momentum * mean0 + (1 - momentum) * mean,
            momentum * var0 + (1 - momentum) * var * n / max(n - 1.0, 1.0),
            var)


def main():
    torch.set_num_threads(os.cpu_count() or 1)
    os.makedirs(cs.WORK, exist_ok=True)
    csv = cs.ssl_parity_csv()
    rec, st = cs.ssl_record()
    ms = st["modes"]["mcm-lp"]
    cfg = fused.config_from_args(fused.build_parser().parse_args([
        "--dataset", csv, "--mode", "mcm-lp", "--channels",
        str(st["channels"]), "--num_layers", str(st["num_layers"]),
        "--num_neg_samples", str(st["num_neg_samples"]), "--batch_size",
        str(st["batch_size"]), "--khop_neighbors",
        *map(str, st["khop_neighbors"]), "--dropout", "0", "--lr",
        str(st["lr"]), "--device", "cpu"])).replace(
        edge_capacity=ms["edge_capacity"], node_capacity=ms["node_capacity"],
        seed=st["seed"])
    tr = PretrainTrainer(cfg, build_dataset(cfg), "mcm-lp")
    tr.model.load_state_dict(from_jax(
        random_variables(ms["shapes"], st["var_seed"]), tr.model))
    gb = next(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", st["epoch"]), 1))

    pna_calls, bn_calls = [], []

    def capture_pna(*args):
        pna_calls.append(args)
        return pna_aggregate(*args)

    stats0 = {id(m): (m.running_mean.clone(), m.running_var.clone())
              for m in tr.model.modules() if isinstance(m, MaskedBatchNorm)}
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: bn_calls.append((mod, inp[0].detach().clone(),
                                          inp[1].detach().clone())))
             for m in tr.model.modules() if isinstance(m, MaskedBatchNorm)]
    port_conv.pna_aggregate = capture_pna
    tr.model.train()
    with torch.no_grad():
        tr._forward(gb.to("cpu"))
    port_conv.pna_aggregate = pna_aggregate
    for h in hooks:
        h.remove()

    worst: dict = {}
    seen: dict = {}
    for i, ((mod, x, mask), pna) in enumerate(zip(bn_calls, pna_calls)):
        # the running statistics this call started from: the module's
        # initial ones, or those its previous call (the LP view) left
        mean0, var0 = seen.get(id(mod), stats0[id(mod)])
        w, b = mod.weight.detach(), mod.bias.detach()
        y64, rm64, rv64, bvar = batchnorm64(
            x.double().numpy(), mask.numpy(), w.double().numpy(),
            b.double().numpy(), mean0.double().numpy(),
            var0.double().numpy())
        port = MaskedBatchNorm(x.shape[1]).train()
        port.load_state_dict({"weight": w, "bias": b, "running_mean": mean0,
                              "running_var": var0})
        with torch.no_grad():
            y_port = port(x, mask).numpy()
        y_jax, upd = JaxBatchNorm(x.shape[1]).apply(
            {"params": {"scale": jnp.asarray(w.numpy()),
                        "bias": jnp.asarray(b.numpy())},
             "batch_stats": {"mean": jnp.asarray(mean0.numpy()),
                             "var": jnp.asarray(var0.numpy())}},
            jnp.asarray(x.numpy()), jnp.asarray(mask.numpy()), True,
            mutable=["batch_stats"])
        seen[id(mod)] = (port.running_mean.clone(), port.running_var.clone())
        real = mask.numpy().astype(bool)
        msg, dst, n, ald, emask = pna
        agg64 = pna_aggregate(msg.double(), dst, n, ald, emask).numpy()
        agg_port = pna_aggregate(msg, dst, n, ald, emask).numpy()
        agg_jax = np.asarray(jax_pna(jnp.asarray(msg.numpy()),
                                     jnp.asarray(dst.numpy()), n, ald,
                                     jnp.asarray(emask.numpy())))
        f = msg.shape[1]
        mean_b, std_b = slice(0, f), slice(3 * f, 4 * f)
        line = {
            "call": i, "view": "lp" if i < len(bn_calls) // 2 else "mcm",
            "real_nodes": int(real.sum()),
            "bn_min_batch_var": float(bvar.min()),
            "bn_out_err_port": float(np.abs(y_port - y64)[real].max()),
            "bn_out_err_jax": float(np.abs(np.asarray(y_jax) - y64)[real]
                                    .max()),
            "bn_out_port_vs_jax": float(np.abs(y_port - np.asarray(y_jax))
                                        [real].max()),
            "bn_running_err_port": float(max(
                np.abs(port.running_mean.numpy() - rm64).max(),
                np.abs(port.running_var.numpy() - rv64).max())),
            "bn_running_err_jax": float(max(
                np.abs(np.asarray(upd["batch_stats"]["mean"]) - rm64).max(),
                np.abs(np.asarray(upd["batch_stats"]["var"]) - rv64).max())),
            "pna_lanes": int(emask.sum()),
            "pna_mean_err_port": float(np.abs(agg_port - agg64)[:, mean_b]
                                       .max()),
            "pna_mean_err_jax": float(np.abs(agg_jax - agg64)[:, mean_b]
                                      .max()),
            "pna_std_err_port": float(np.abs(agg_port - agg64)[:, std_b]
                                      .max()),
            "pna_std_err_jax": float(np.abs(agg_jax - agg64)[:, std_b]
                                     .max()),
            "pna_std_scale": float(np.abs(agg64[:, std_b]).max())}
        print(json.dumps(line), flush=True)
        for k, v in line.items():
            if k.startswith(("bn_out", "bn_running", "pna_")) and \
                    k != "pna_lanes":
                worst[k] = max(worst.get(k, 0.0), v)
    print(json.dumps({"largest": worst, "calls": len(bn_calls)}))


if __name__ == "__main__":
    main()
