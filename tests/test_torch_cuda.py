"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
GPU).  This file imports no JAX, so it runs on a GPU machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs;
the tolerances cover fp32 sums taken in another order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement
from repro_torch.data.federated import table2_fleet
from repro_torch.kernels import ref
from repro_torch.kernels.defense_sim import sketch_similarity
from repro_torch.kernels.fedavg_agg import fedavg_agg
from repro_torch.kernels.local_sgd import local_sgd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, decided inside the test (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels build with nvcc at first use")
    return torch.device("cuda")


def _sgd_inputs(dev, I=16, H=8, C=10, R=4, n=37, seed=0):
    gen = torch.Generator().manual_seed(seed)
    D = H + C + I * H + H * C
    g = torch.randn(D, generator=gen) * 0.3
    x = torch.rand(R, n, I, generator=gen)
    y = torch.randint(0, C, (R, n), generator=gen, dtype=torch.int32)
    act = (torch.arange(R) % 2).to(torch.int32)  # mixed ReLU / softmax
    mask = torch.ones(R, n, dtype=torch.bool)
    mask[1, 25:] = False  # ragged client
    mask[2, :] = False  # all-False client
    mask[3, :20] = False  # one all-padding batch
    return tuple(t.to(dev) for t in (g, x, y, act, mask))


@pytest.mark.parametrize("I,H", [(16, 8), (784, 128)])
def test_local_sgd_kernel_matches_plain(cuda_device, I, H):
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=I, H=H)
    kw = dict(hidden=H, classes=10, lr=0.1, batch_size=20, epochs=3)
    n0 = local_sgd.launches
    got = local_sgd(g, x, y, act, mask, **kw)
    assert local_sgd.launches == n0 + 1
    torch.testing.assert_close(got, ref.local_sgd_ref(g, x, y, act, mask, **kw),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got[2], g)  # all-False client: unchanged


def test_fedavg_agg_kernel_matches_plain(cuda_device):
    dev = cuda_device
    d, w = torch.randn(33, 1001, device=dev), torch.rand(33, device=dev)
    tau = torch.rand(33, device=dev) * 3
    for stale in (None, tau):
        torch.testing.assert_close(fedavg_agg(d, w, staleness=stale),
                                   ref.fedavg_agg_ref(d, w, stale),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n,k", [(13, 29, 300), (12, 12, 20000), (40, 40, 256)])
def test_sketch_similarity_kernel_matches_plain(cuda_device, m, n, k):
    a = torch.randn(m, k, device=cuda_device)
    b = torch.randn(n, k, device=cuda_device)
    a, b = (t / torch.linalg.vector_norm(t, dim=1, keepdim=True) for t in (a, b))
    torch.testing.assert_close(sketch_similarity(a, b),
                               ref.sketch_similarity_ref(a, b),
                               rtol=1e-5, atol=1e-5)


def test_wrappers_validate_arguments(cuda_device):
    dev = cuda_device
    d = torch.randn(4, 10, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        fedavg_agg(d.double(), torch.rand(4, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        sketch_similarity(torch.randn(10, 4, device=dev).t(), d)
    g, x, y, act, mask = _sgd_inputs(dev)
    with pytest.raises(ValueError, match="dtype"):
        local_sgd(g, x, y.long(), act, mask, hidden=8, classes=10, lr=0.1,
                  batch_size=20, epochs=1)


def test_round_on_the_card_matches_plain_route(cuda_device):
    """The engine on its default device (the card): every kernel launches,
    and the plain route gives the same trust and masks exactly and params
    within 2e-4."""
    data = table2_fleet(samples_per_client=60)
    fed = fleet_fed(12, defense="foolsgold_sketch")
    counts = [k.launches for k in (local_sgd, fedavg_agg, sketch_similarity)]
    server = FedARServer(small_model(32), fed, TaskRequirement())
    assert server.engine.device.type == "cuda"
    server.run(data, rounds=3)
    after = [k.launches for k in (local_sgd, fedavg_agg, sketch_similarity)]
    assert all(a > c for a, c in zip(after, counts))
    plain = FedARServer(small_model(32), dataclasses.replace(
        fed, sgd_impl="einsum", agg_impl="einsum", defense_impl="einsum"),
        TaskRequirement(), device=cuda_device)
    plain.run(data, rounds=3)
    for key in ("trust", "selected", "on_time"):
        np.testing.assert_array_equal(np.stack(server.history[key]),
                                      np.stack(plain.history[key]))
    torch.testing.assert_close(server.state.params, plain.state.params,
                               rtol=2e-4, atol=2e-4)
