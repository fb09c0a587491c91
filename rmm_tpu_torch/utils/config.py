"""Typed configuration and the CLI flag surface.

Same flags as ``rmm_tpu/utils/config.py`` (so a command line moves between
the two packages unchanged), plus ``--device``. Flags whose behaviour is
not ported yet (``UNPORTED``) are accepted at their defaults and rejected
otherwise, never silently ignored.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence


@dataclasses.dataclass
class Config:
    # model
    model: str = "fttransformer"
    n_hidden: int = 32
    n_gnn_layers: int = 2
    emlps: bool = False
    reverse_mp: bool = False
    ego: bool = False
    ports: bool = False
    dropout: float = 0.083
    nhead: int = 8

    # task / data
    data: str = ""
    task: str = "edge_classification"
    n_classes: int = 2
    pretrain: Sequence[str] = ()
    split_type: str = "temporal_daily"
    splits: Sequence[float] = (0.6, 0.2, 0.2)
    num_neighs: Sequence[int] = (100, 100)
    edge_capacity: int = 0            # 0 = auto-calibrate from probe batches
    node_capacity: int = 0
    max_drop_rate: float = 0.0        # warn when epoch drop-rate exceeds this

    # optimization (AML supervised config of record)
    lr: float = 0.0006116418195373612
    epochs: int = 100
    batch_size: int = 200
    w_ce1: float = 1.0
    w_ce2: float = 9.23
    weight_decay: float = 1e-3        # SSL only; supervised Adam has none
    adam_eps: float = 1e-8
    num_neg_samples: int = 64
    moo: str = "sum"

    # misc
    sampler_threads: int = 1      # >1: host sampling on a thread pool
    precision: str = "f32"        # f32 | bf16 (tabgnn, tabgnnfused)
    device: str = "cuda"          # cuda | cpu (cpu: tests, no kernels)

    seed: int = 1
    testing: bool = False
    tqdm: bool = False
    save_model: bool = False
    load_model: Optional[str] = None
    checkpoint: bool = False
    freeze: bool = False
    output_path: str = "outputs/"
    wandb_dir: str = "wandb/"
    group: str = "null"
    log_every: int = 50

    @property
    def loss_weights(self) -> list[float]:
        if self.n_classes == 2:
            return [self.w_ce1, self.w_ce2]
        return [1.0] * self.n_classes

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str)


#: flag → the only value this slice accepts (the JAX package's default)
UNPORTED = {"frontier_capacity": 0, "dp": 0, "steps_per_dispatch": 1,
            "inflight_groups": 2, "scan_layers": False,
            "ckpt_backend": "msgpack"}


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--emlps", action="store_true")
    p.add_argument("--reverse_mp", action="store_true")
    p.add_argument("--ego", action="store_true")
    p.add_argument("--ports", action="store_true")
    p.add_argument("--batch_size", default=200, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--num_neighs", nargs="+", type=int, default=[100, 100])
    p.add_argument("--n_hidden", default=32, type=int)
    p.add_argument("--n_gnn_layers", default=2, type=int)
    p.add_argument("--model", default=None, type=str, required=True)
    p.add_argument("--freeze", action="store_true")
    p.add_argument("--seed", default=1, type=int)
    p.add_argument("--tqdm", action="store_true")
    p.add_argument("--data", default=None, type=str, required=True)
    p.add_argument("--output_path", default="outputs/", type=str)
    p.add_argument("--testing", action="store_true")
    p.add_argument("--save_model", action="store_true")
    p.add_argument("--load_model", default=None, type=str)
    p.add_argument("--checkpoint", action="store_true")
    p.add_argument("--wandb_dir", default="wandb/", type=str)
    p.add_argument("--group", default="null", type=str)
    p.add_argument("--task", default="edge_classification", type=str)
    p.add_argument("--edge_capacity", default=0, type=int,
                   help="static subgraph edge buffer (0 = auto-calibrate)")
    p.add_argument("--node_capacity", default=0, type=int,
                   help="static subgraph node buffer (0 = auto-calibrate)")
    p.add_argument("--frontier_capacity", default=0, type=int)
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--dropout", default=None, type=float)
    p.add_argument("--dp", default=0, type=int)
    p.add_argument("--steps_per_dispatch", default=1, type=int)
    p.add_argument("--sampler_threads", default=1, type=int)
    p.add_argument("--inflight_groups", default=2, type=int)
    p.add_argument("--sampler", default="auto",
                   choices=("auto", "host", "device"))
    p.add_argument("--precision", default="f32", choices=("f32", "bf16"))
    p.add_argument("--scan_layers", action="store_true")
    p.add_argument("--ckpt_backend", default="msgpack",
                   choices=("msgpack", "orbax"))
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    for flag, default in UNPORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(f"--{flag} is not ported yet")
    if args.sampler == "device":
        raise NotImplementedError("--sampler device is not ported yet")
    cfg = Config(
        model=args.model, data=args.data, task=args.task,
        batch_size=args.batch_size, epochs=args.epochs,
        num_neighs=tuple(args.num_neighs), n_hidden=args.n_hidden,
        n_gnn_layers=args.n_gnn_layers, emlps=args.emlps,
        reverse_mp=args.reverse_mp, ego=args.ego, ports=args.ports,
        seed=args.seed, tqdm=args.tqdm, testing=args.testing,
        save_model=args.save_model, load_model=args.load_model,
        checkpoint=args.checkpoint, freeze=args.freeze,
        output_path=args.output_path, wandb_dir=args.wandb_dir,
        group=args.group, edge_capacity=args.edge_capacity,
        node_capacity=args.node_capacity,
        sampler_threads=args.sampler_threads, precision=args.precision,
        device=args.device,
    )
    if args.lr is not None:
        cfg = cfg.replace(lr=args.lr)
    if args.dropout is not None:
        cfg = cfg.replace(dropout=args.dropout)
    # dataset-specific overrides of record (same as the JAX package)
    if "ethereum-phishing" in cfg.data:
        cfg = cfg.replace(lr=0.0008, dropout=0.123, w_ce2=1.16,
                          n_gnn_layers=2)
    elif "elliptic" in cfg.data:
        cfg = cfg.replace(task="node_classification")
    elif "ogbn_arxiv" in cfg.data or "ogbn-arxiv" in cfg.data:
        cfg = cfg.replace(task="node_classification", n_classes=40)
    return cfg
