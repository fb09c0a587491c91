"""The PyTorch port on an NVIDIA card: each CUDA kernel against its plain
PyTorch version on the same card, and the predict CLI on the card against
the same CLI on the CPU.

The kernels have no CPU mode, so these tests skip on a machine without a
card. On one with a card (JAX need not be installed there: the JAX suite's
``tests/conftest.py`` is skipped) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel against plain 1e-5 abs/rel (float32, sums in another
order); served scores, card against CPU, 1e-4 (PNA sums in another order).
"""
import numpy as np
import pytest
import torch

from rmm_tpu_torch.ops import column_attention as ca

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def attention_inputs(seed, b, s, c, device):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(b, s, c), rng.randn(c, 3 * c) / np.sqrt(c),
              rng.randn(3 * c) * 0.1, rng.randn(c, c) / np.sqrt(c),
              rng.randn(c) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in arrays]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", [
    (1, 1, 32, 8),       # one row, one token
    (37, 2, 32, 8),      # node tokens at the serving width, ragged batch
    (4099, 6, 32, 8),    # edge tokens at the serving width
    (515, 3, 48, 6),     # odd S, head_dim 8
    (257, 9, 64, 4),     # largest width with the weights in shared memory
    (70, 16, 16, 1),     # the largest S, one head
    (33, 6, 96, 3),      # weights through the read-only cache
    (100, 16, 128, 8),   # the largest S and C
])
def test_column_attention_kernel_matches_plain(cuda, b, s, c, h, masked):
    args = attention_inputs(b + s + c, b, s, c, cuda)
    mask, rate = None, 0.0
    if masked:
        rate = 0.3
        mask = torch.from_numpy(
            np.random.RandomState(b).rand(b, h, s, s) >= rate).to(cuda)
    before = ca.launches
    with torch.inference_mode():
        out = ca.fused_column_attention(*args, h, mask, rate)
        ref = ca.reference_column_attention(*args, h, mask, rate)
    assert ca.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


def test_column_attention_kernel_refuses_what_it_cannot_run(cuda):
    x, wqkv, bqkv, wout, bout = attention_inputs(0, 8, 6, 32, cuda)
    before = ca.launches
    with pytest.raises(TypeError, match="float32"):
        ca.fused_column_attention(x.bfloat16(), wqkv, bqkv, wout, bout, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ca.fused_column_attention(x, wqkv.t().contiguous().t(), bqkv, wout,
                                  bout, 8)
    with pytest.raises(ValueError, match="is on cpu"):
        ca.fused_column_attention(x, wqkv.cpu(), bqkv, wout, bout, 8)
    with pytest.raises(ValueError, match="S <= 16"):
        ca.fused_column_attention(torch.zeros(8, 17, 32, device=cuda), wqkv,
                                  bqkv, wout, bout, 8)
    with pytest.raises(NotImplementedError, match="backward"):
        ca.fused_column_attention(x, wqkv.requires_grad_(), bqkv, wout,
                                  bout, 8)
    assert ca.launches == before


def test_predict_on_the_card_matches_the_cpu(cuda, tmp_path):
    from rmm_tpu_torch.cli import predict
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.checkpoint import save_checkpoint
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    data = str(tmp_path / "aml.csv")
    write_synthetic_aml_csv(data, num_rows=2000, num_accounts=125, seed=0)
    argv = ["--data", data, "--model", "tabgnn", "--num_neighs", "10", "10",
            "--batch_size", "64", "--split", "test"]
    cfg = config_from_args(create_parser().parse_args(
        argv[:-2] + ["--device", "cpu"]))
    state = Trainer(cfg, build_dataset(cfg)).model.state_dict()
    g = torch.Generator().manual_seed(0)
    for name, t in state.items():   # biases and BatchNorm stats off init
        if t.is_floating_point():
            noise = (torch.rand(t.shape, generator=g)
                     if name.endswith("running_var")
                     else 0.1 * torch.randn(t.shape, generator=g))
            t.add_(noise)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), state)
    argv += ["--load_model", ckpt]

    host = predict.main(argv + ["--output", str(tmp_path / "cpu.csv"),
                                "--device", "cpu"])
    before = ca.launches
    card_stats = {}
    card = predict.main(argv + ["--output", str(tmp_path / "cuda.csv"),
                                "--device", "cuda"], card_stats)
    batches = -(-len(card["id"]) // 64)
    assert ca.launches - before == 4 * batches   # 2 layers x nodes, edges
    assert card_stats["device"].startswith("cuda")
    np.testing.assert_array_equal(card["id"], host["id"])
    np.testing.assert_allclose(card["score"], host["score"], rtol=1e-4,
                               atol=1e-4)
    clear = np.abs(host["score"] - 0.5) > 1e-4
    np.testing.assert_array_equal(card["pred"][clear], host["pred"][clear])
